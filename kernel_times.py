#!/usr/bin/env python3
"""The kernel phase of ``chip_smoke.py`` over a given source tree, so that
two commits' kernels are timed by one method, in one process each, in
one run on the card:

    python3 kernel_times.py --src DIR [--out FILE]

DIR is the ``src`` directory of a checkout, e.g. a ``git archive`` of
another commit unpacked under ``build/``. Every kernel case of
``chip_smoke.kernel_cases`` and ``chip_smoke.ssd_cases`` runs against
that tree's kernels, with this checkout's ``time_ms`` (L2 flushed, the
host's enqueueing outside the timed window). It holds each kernel to its
plain version as those functions do, and checks no design goal of this
checkout's kernels. Cases a tree's kernel has no instance for (head dim
80, h2o-danube's, and 16, the trained speculation's, before they were
built; grouped_ffn_bwd before it existed) are left out for that tree;
a tree without ``repro_torch/launch/roofline.py`` takes this checkout's
peaks for the bounds. Prints one JSON line per case (source, kernel,
dtype, case, ms, the library call's or yardstick's ms, CUDA kernels per
call);
FILE gets every case in full. To compare commits A and B, run A, B, B, A in one call."""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import chip_smoke

KEYS = ("dtype", "case", "policy", "model", "lengths", "init_state",
        "dt_shift", "rel_err", "bit_equal",
        "active", "max_active", "ms", "library_ms", "ms_over_sdpa",
        "grouped_mm_ms", "kernels_per_call", "max_abs_err", "ok")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True, type=Path)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args()
    torch = chip_smoke.torch
    if not torch.cuda.is_available():
        print("kernel_times: CUDA is not available", file=sys.stderr)
        return 2
    src = args.src.resolve()
    sys.path.insert(0, str(src))
    import repro_torch
    from repro_torch.configs.registry import ARCHS
    from repro_torch.kernels import build
    if src not in Path(repro_torch.__file__).resolve().parents:
        raise RuntimeError(f"repro_torch came from {repro_torch.__file__}")
    try:
        import repro_torch.launch.roofline  # noqa: F401  (the peaks)
    except ModuleNotFoundError:   # a tree from before it: this checkout's
        name = "repro_torch.launch.roofline"
        spec = importlib.util.spec_from_file_location(
            name, chip_smoke.ROOT / "src/repro_torch/launch/roofline.py")
        sys.modules[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[name])
    torch.backends.cuda.matmul.allow_tf32 = False
    build.build()
    from repro_torch import kernels as K
    with torch.no_grad():
        cases = chip_smoke.kernel_cases(ARCHS)
        cases["ssd_scan"] = chip_smoke.ssd_cases(ARCHS)
        if hasattr(K, "grouped_ffn_bwd"):
            cases["grouped_ffn_bwd"] = chip_smoke.grouped_bwd_cases(ARCHS)
    card = chip_smoke.gpu_name_power()
    for name, cs in cases.items():
        for c in cs:
            print(json.dumps(dict(src=str(args.src), kernel=name, card=card,
                                  **{k: c[k] for k in KEYS if k in c})),
                  flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(dict(src=str(args.src), card=card,
                                            cases=cases)))
    bad = [(n, c["dtype"]) for n, cs in cases.items() for c in cs
           if not c["ok"]]
    if bad:
        print(f"kernel_times: disagree with their plain versions: {bad}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
