"""S3Tok, the DiT architecture's speech tokenizer."""
from .model import (  # noqa: F401
    S3_SR,
    S3TokConfig,
    drop_invalid_tokens,
    s3tok_fsq,
    s3tok_param_tree,
    s3tok_tokenize,
)
