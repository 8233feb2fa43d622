"""EgoVLPv2 in PyTorch for NVIDIA Hopper: the port of `egovlpv2_tpu`.

The JAX package stays the reference: every module here mirrors the one of
the same path under `egovlpv2_tpu/`, and the tests hold each against it on
the same parameters and inputs. Plain tensor code is PyTorch; the TPU's
Pallas kernels become CUDA kernels written by hand for `sm_90a`
(`csrc/`, built and bound by `ops/_kernels.py`).

This package imports `torch` and never `jax` or `flax`, and nothing of
`egovlpv2_tpu`: what it needs of that package's framework-free modules
(the config tree, the tokenizer adapter, the MLM collator, the EgoMCQ
metric) it keeps as its own copies under the same relative paths, and a
test holds each copy against its original.
"""

__version__ = "0.1.0"
