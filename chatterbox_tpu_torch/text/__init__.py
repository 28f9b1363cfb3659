from .processing import split_text_into_chunks
from .segmenter import segment_sentences

__all__ = ["split_text_into_chunks", "segment_sentences"]
