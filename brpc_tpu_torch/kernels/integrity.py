"""B2: the integrity word of one staged chunk (csrc/integrity_word.cu)
and its plain version.

Replaces brpc_tpu/device_path.py:38-49 (`_integrity_word`).
`integrity_word` dispatches on the tensor's device: a CPU tensor goes to
`integrity_word_ref`, a CUDA tensor launches the hand kernel (or
raises) with one kernel launch per call, whatever the input's length or
alignment. It counts its kernel launches in `integrity_word.launches`.
"""
from __future__ import annotations

import torch

from brpc_tpu_torch.convert import int64_to_uint32, uint32_to_int64
from brpc_tpu_torch.kernels import _build

_MASK = 0xFFFFFFFF


def integrity_word_ref(words: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: sum of words[i] * (2i + 1), each product
    and the sum masked to 32 bits. uint32[n] -> uint32[]."""
    w = uint32_to_int64(words)
    idx = torch.arange(w.shape[-1], dtype=torch.int64, device=w.device)
    return int64_to_uint32(((w * (2 * idx + 1)) & _MASK).sum() & _MASK)


def integrity_word(words: torch.Tensor) -> torch.Tensor:
    """Integrity word of uint32[n] -> uint32[] (a 0-d tensor on the
    input's device)."""
    if words.dtype != torch.uint32 or words.dim() != 1:
        raise TypeError(f"expected uint32[n], got {words.dtype}{tuple(words.shape)}")
    if words.device.type == "cpu":
        return integrity_word_ref(words)
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    if not words.is_contiguous():
        raise ValueError("words must be contiguous")
    with torch.cuda.device(words.device):
        # The kernel writes the word; nothing is zeroed first.
        out = torch.empty((), dtype=torch.int32, device=words.device)
        _build.launch("brpc_tpu_torch_integrity_word",
                      words.data_ptr(), out.data_ptr(), words.numel(),
                      torch.cuda.current_stream().cuda_stream)
    integrity_word.launches += 1
    return out.view(torch.uint32)


integrity_word.launches = 0
