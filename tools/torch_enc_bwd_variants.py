#!/usr/bin/env python3
"""Variants of the port's encoded MLP backward (kernel #4), built from
``csrc/fused_mlp_enc.cu`` by text substitutions, held to the shipped
kernel's outputs and timed on the same inputs.

    python3 tools/torch_enc_bwd_variants.py [--inputs smoke_out/parent_inputs.pt]

Needs an NVIDIA H100 and nvcc. The variants:
  frag      the shipped kernel: gated on g != 0, tile-fragment scratch,
            weight-gradient stages of active tiles only, dW_in's features
            stored by the chain and read back;
  rowmajor  gated on g != 0, row-major scratch, stages skipped only where
            all four of their tiles are inactive, and dW_in's features
            formed again for every row of an active stage;
  ungated   every point active, the features formed again (the kernel
            before the gate).
Each variant's sources are copied into ``smoke_out/enc_bwd_variants/<name>/``
and built there by ``ops/kernels/build.py``, all at once, one process a
variant; then each runs in a process of its own, in the order frag,
rowmajor, ungated, ungated, rowmajor, frag. The inputs are the encoded cases
``chip_smoke.py --parent`` saves (random g at two point counts, BARF at
three alphas, the fourier run's trained state) with ``--inputs``, else the
random fourier cases alone. Prints one line a case and variant: CUDA-event
medians (ms, both readings), the chain / weight-gradient / rest device
times (torch.profiler), the largest gradient error against the plain
version (normalised) and whether the outputs equal the shipped kernel's bit
for bit but for the sign of a zero; the report goes to
``smoke_out/enc_bwd_variants.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "nerf_for_angiography_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "smoke_out", "enc_bwd_variants")

# (text of csrc/fused_mlp_enc.cu, its replacement)
VARIANTS = {
    "frag": [],
    "rowmajor": [("constexpr bool ENC_FRAG_SCRATCH = true;",
                  "constexpr bool ENC_FRAG_SCRATCH = false;")],
    "ungated": [("using BwdX = GatedEncX<KE, ENC_FRAG_SCRATCH>;", "using BwdX = EncX<KE>;"),
                ("BwdX<KK>{{xs, a, w, n_enc}, g, feat}", "BwdX<KK>{xs, a, w, n_enc}")],
}
ORDER = ("frag", "rowmajor", "ungated", "ungated", "rowmajor", "frag")


def variant_dir(name: str) -> str:
    """Copy csrc/ into the variant's directory with its substitutions."""
    d = os.path.join(OUT, name)
    src = os.path.join(d, "csrc")
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(CSRC, src)
    path = os.path.join(src, "fused_mlp_enc.cu")
    with open(path) as fh:
        text = fh.read()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise SystemExit(f"variant {name}: {old!r} is not in csrc/fused_mlp_enc.cu")
        text = text.replace(old, new)
    with open(path, "w") as fh:
        fh.write(text)
    return d


def child(name: str, inputs: str | None, build_only: bool) -> dict:
    """In this process: build (or load) the variant's library, then run
    every case."""
    from pathlib import Path

    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from nerf_for_angiography_tpu_torch.ops.kernels import build
    from nerf_for_angiography_tpu_torch.ops.kernels import fused_mlp as fm
    from nerf_for_angiography_tpu_torch.ops.kernels import fused_mlp_enc as fe

    d = Path(OUT) / name
    build.CSRC_DIR, build.BUILD_DIR = d / "csrc", d / "build"
    fe._load_lib()
    log = fe.build_log
    if build_only:
        return dict(ptxas=cs.ptxas_summary(log, 128, ke=48))
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    if inputs:
        enc = torch.load(inputs)["enc"]
        enc = dict(enc, models={k: (tuple(t.to(dev) for t in pk), a.to(dev), w.to(dev))
                                for k, (pk, a, w) in enc["models"].items()},
                   inputs={k: (x.to(dev), g.to(dev)) for k, (x, g) in enc["inputs"].items()})
    else:
        packed, _, (_, a, w), gen = cs.random_enc(torch, fm, fe, "fourier")
        gen.manual_seed(6)
        enc = dict(models={"fourier": (tuple(packed), a, w)}, inputs={}, cases={})
        for p in cs.BWD_RANDOM_P:
            enc["inputs"][f"random: P={p}"] = (
                (torch.rand((p, 3), generator=gen) * 2.0 - 1.0).to(dev),
                (torch.randn((p,), generator=gen) / p).to(dev))
            enc["cases"][f"random: fourier, P={p}"] = ("fourier", f"random: P={p}")
    ref_path = os.path.join(OUT, "frag_outputs.pt")
    ref = torch.load(ref_path) if name != "frag" and os.path.exists(ref_path) else None
    out, mine = {}, {}
    for case in enc["cases"]:
        launch = cs.enc_launch(fm, fe, enc, case)
        got, again = launch(), launch()

        def flat(o):
            return [t for pair in o[0] for t in pair] + [o[1], o[2]]

        same = all(torch.equal(u, v) for u, v in zip(flat(got), flat(again)))
        mk, ik = enc["cases"][case]
        pk, a, w = enc["models"][mk]
        x, g = enc["inputs"][ik]
        want = fe.fused_mlp_enc_bwd_reference(fm.PackedMLP(*pk), a, w, x, g)
        err = max(cs.grad_norm_errs(got[0], want[0])
                  + cs.grad_norm_errs([(got[1],)], [(want[1],)]))
        mine[case] = cs.canonical_outputs(torch, got)
        equal = None
        if ref is not None:
            r = ref[case]
            equal = (all(torch.equal(u, v) for u, v in zip(mine[case]["grads"], r["grads"]))
                     and torch.equal(mine[case]["da"], r["da"])
                     and mine[case]["dx_sha1"] == r["dx_sha1"])
        out[case] = dict(ms=cs.time_ms(torch, launch), parts_ms=cs.bwd_parts_ms(torch, launch),
                         grad_norm_err=err, deterministic=same, equal_shipped=equal)
    if name == "frag":
        torch.save(mine, ref_path)
    return out


def run_child(name: str, inputs: str | None, build_only: bool = False) -> dict:
    cmd = [sys.executable, os.path.abspath(__file__), "--child", name]
    cmd += ["--inputs", inputs] if inputs else []
    cmd += ["--build-only"] if build_only else []
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise SystemExit(f"variant {name} failed ({proc.returncode}): {proc.stderr[-3000:]}")
    return json.loads(lines[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--inputs", default=None,
                    help="chip_smoke.py --parent's saved inputs (smoke_out/parent_inputs.pt)")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--build-only", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    inputs = os.path.abspath(args.inputs) if args.inputs else None
    if args.child:
        print(json.dumps(child(args.child, inputs, args.build_only)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_enc_bwd_variants: CUDA is not available", file=sys.stderr)
        return 2
    os.makedirs(OUT, exist_ok=True)
    for name in VARIANTS:
        variant_dir(name)
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        built = dict(zip(VARIANTS, ex.map(lambda n: run_child(n, None, True), VARIANTS)))
    for name, b in built.items():
        print(f"{name}: ptxas {b['ptxas']}")
    runs: dict[str, list] = {name: [] for name in VARIANTS}
    for name in ORDER:
        runs[name].append(run_child(name, inputs))
    report = {"ptxas": built, "runs": runs}
    ok = True
    for case in runs["frag"][0]:
        for name in VARIANTS:
            a, b = (r[case] for r in runs[name])
            parts = " / ".join(f"{(x + y) / 2:.4f}" for x, y in zip(a["parts_ms"].values(),
                                                                    b["parts_ms"].values())) \
                if a["parts_ms"] and b["parts_ms"] else "not measured"
            print(f"{case}, {name}: {a['ms']:.4f} / {b['ms']:.4f} ms (mean "
                  f"{(a['ms'] + b['ms']) / 2:.4f}); chain / weight gradients / rest {parts} ms; "
                  f"max normalised grad err against the plain version {a['grad_norm_err']:.3e}; "
                  f"deterministic {a['deterministic'] and b['deterministic']}; equal to frag "
                  f"but for the sign of a zero {a['equal_shipped']}")
            ok &= a["deterministic"] and b["deterministic"] and a["grad_norm_err"] <= 3e-2
            ok &= a["equal_shipped"] is not False and b["equal_shipped"] is not False
    with open(os.path.join(ROOT, "smoke_out", "enc_bwd_variants.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    print(json.dumps({"ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
