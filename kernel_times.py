#!/usr/bin/env python3
"""Times the port's two kernels (B1 adler_frame_checksum, B2
integrity_word) as found in a checkout of the repo, with chip_smoke's
harness (CUDA graph replay timed with CUDA events, inputs cycled over
128 MiB).

    python3 kernel_times.py [ROOT]

ROOT is the checkout whose `brpc_tpu_torch` is built and timed (default:
this one), for instance a parent commit unpacked with `git archive` into
a directory that .gitignore lists. Two versions are compared in one call
on one card, in turns: parent, change, change, parent. Prints the card
line, then one JSON line per kernel and shape. Needs a CUDA device.
"""
import json
import sys
from pathlib import Path

import numpy as np
import torch

from chip_smoke import SEED, bound, copies_for, graph_ms, nvidia_smi_line

B1_SHAPES = ((8, 1024), (4096, 1024), (32, 262144), (256, 262144))
B2_SIZES = (130048, 261120, 523264)


def main(argv):
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device found", file=sys.stderr)
        return 2
    root = Path(argv[1] if len(argv) > 1 else Path(__file__).parent).resolve()
    sys.path.insert(0, str(root))
    import brpc_tpu_torch
    from brpc_tpu_torch.convert import words_from_numpy
    from brpc_tpu_torch.kernels import _build
    from brpc_tpu_torch.kernels.checksum import adler_frame_checksum
    from brpc_tpu_torch.kernels.integrity import integrity_word
    pkg = Path(brpc_tpu_torch.__file__).resolve().parent
    if pkg.parent != root:
        raise RuntimeError(f"imported {pkg}, not the package under {root}")
    _build.build()
    print(nvidia_smi_line(), flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    cases = [("adler_frame_checksum", adler_frame_checksum,
              rng.integers(0, 2**32, s, dtype=np.uint32), 4 * s[0],
              8 * s[0] * s[1]) for s in B1_SHAPES]
    cases += [("integrity_word", integrity_word,
               rng.integers(0, 2**32, n, dtype=np.uint32), 4, 4 * n)
              for n in B2_SIZES]
    for name, fn, arr, out_bytes, ops in cases:
        xs = [words_from_numpy(arr, dev) for _ in range(copies_for(arr.nbytes))]
        ms = graph_ms(fn, xs, 20)
        b_ms, b_by = bound(arr.nbytes + out_bytes, ops)
        print(json.dumps({"root": str(root), "kernel": name,
                          "shape": list(arr.shape), "ms": ms,
                          "bound_ms": b_ms, "bound_by": b_by,
                          "share_of_bound": b_ms / ms}), flush=True)
        del xs
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
