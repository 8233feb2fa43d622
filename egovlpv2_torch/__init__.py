"""EgoVLPv2 in PyTorch for NVIDIA Hopper: the port of `egovlpv2_tpu`.

The JAX package stays the reference: every module here mirrors the one of
the same path under `egovlpv2_tpu/`, and the tests hold each against it on
the same parameters and inputs. Plain tensor code is PyTorch; the TPU's
Pallas kernels become CUDA kernels written by hand for `sm_90a`
(`csrc/`, built and bound by `ops/_kernels.py`).

This package imports `torch` and never `jax` or `flax`. From
`egovlpv2_tpu` it imports only modules that are free of JAX:
`core.config`, `data.loader`, `metrics.retrieval` and `cli`'s config and
batch helpers.
"""

__version__ = "0.1.0"
