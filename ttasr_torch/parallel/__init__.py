"""Tensor-parallel decoding over ``torch.distributed``."""
