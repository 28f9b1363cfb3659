"""A frozen copy of the port's plain model code, for the reference alone:
``chatterbox_tpu_torch``'s T3, S3Gen (ref and DiT), S3Tok, VoiceEncoder
and CAMPPlus parameter trees, ops, text chunking and crossfade, with K2's
plain form in place of its kernel, the tensor-parallel operators as their
plain products, and what the reference does not run left out. The
program's own files may change; these do not.
"""
