#!/usr/bin/env python3
"""Variants of the port's wgmma MLP forward (kernel #1), built from
``csrc/mlp_wgmma.cuh`` by text substitutions, each checked against the plain
version at every width and timed at the dense path's shapes.

    python3 tools/torch_fwd_variants.py [--parent DIR] [--only a,b]

Needs an NVIDIA H100 and nvcc. Each variant is compiled with ``-Xptxas -v``
into ``smoke_out/fwd_variants/<name>/`` beside a small C entry point that
launches it as ``csrc/fused_mlp.cu::fused_mlp_fwd`` does, and runs in a
process of its own (a faulting variant cannot take the others down); the
shipped header runs first and last. With ``--parent DIR`` (a checkout of
another commit) that checkout's ``fused_mlp_fwd_cuda`` is timed on the same
inputs in a process of its own. Prints one line a variant: registers,
HGMMA count, cases within the forward limits, CUDA-event medians (ms); the
full report goes to ``smoke_out/fwd_variants.json``. Times are back to
back (20 launches between two CUDA events).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "nerf_for_angiography_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "smoke_out", "fwd_variants")
SHAPES = (1_687_500, 900_000, 2_097_152, 524_288)  # dense, lattice k=160, grid EMA
FWD_MAX_REL, FWD_MEDIAN_REL = 2e-2, 1e-3

ENTRY = r'''
#include "mlp_wgmma.cuh"
extern "C" int variant_fwd(const float* x, long long sp, long long sc, long long P,
                           const void* w_in, const void* w_hid, const float* bias,
                           const float* w_out, const float* b_out, int F, int nh, float* out,
                           int n_sms, void* stream) {
  if (!dims_ok(F, nh) || n_sms <= 0) return (int)cudaErrorInvalidValue;
  const Params prm{static_cast<const bf16*>(w_in), static_cast<const bf16*>(w_hid), bias, w_out,
                   b_out};
  const StridedX xin{x, sp, sc};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MLP_CHAIN_DISPATCH_F(F, launch_wgmma_fwd<FF>(xin, P, prm, nh, out, n_sms, st))
}
'''

# n-tiles [N0, N0 + NT) of a layer's f32 accumulator d (d[j] is n-tile
# N0 + j) -> bf16(relu(d + bias)) into the A registers of the next layer
HALF_PACK = r'''
template <int F, int N0, int NT>
__device__ __forceinline__ void wg_pack(uint32_t (&a)[F / 16][4], const float (&d)[NT][4],
                                        const float* bias) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int nt = N0 + j, c = nt * 8 + 2 * t;
    const float b0 = bias[c], b1 = bias[c + 1];
    a[nt >> 1][(nt & 1) * 2] = pack2_relu(d[j][0] + b0, d[j][1] + b1);
    a[nt >> 1][(nt & 1) * 2 + 1] = pack2_relu(d[j][2] + b0, d[j][3] + b1);
  }
}
'''

# each hidden layer as two N-halves in two commit groups: the first half's
# epilogue runs while the second half's wgmma is in flight (F % 32 == 0;
# other widths unsplit); the next layer's A goes to other registers
SPLIT = r'''
template <int F, bool SW128>
__device__ __forceinline__ void wg_layer_split(float (&acc)[F / 8][4], uint32_t (&a)[F / 16][4],
                                               uint32_t (&an)[F / 16][4], uint32_t base,
                                               const float* bias) {
  if constexpr (F % 32 != 0) {
    wg_layer<F, F / 16, SW128>(acc, a, base);
    wg_pack<F, 0, F / 8>(an, acc, bias);
  } else {
    constexpr int H = F / 16;  // n-tiles a half
    float(&lo)[H][4] = *reinterpret_cast<float(*)[H][4]>(&acc[0][0]);
    float(&hi)[H][4] = *reinterpret_cast<float(*)[H][4]>(&acc[H][0]);
    const uint32_t hoff = SW128 ? H * 1024 : H * (F / 8) * 128;  // row F / 2
    wg_pin(acc);
    wg_pin(a);
    wgmma_fence();
#pragma unroll
    for (int kt = 0; kt < F / 16; ++kt)
      wgmma_rs<F / 2>(lo, a[kt], wg_kstep_desc<SW128>(base, kt, F, F), kt > 0 ? 1 : 0);
    wgmma_commit();
#pragma unroll
    for (int kt = 0; kt < F / 16; ++kt)
      wgmma_rs<F / 2>(hi, a[kt], wg_kstep_desc<SW128>(base + hoff, kt, F, F), kt > 0 ? 1 : 0);
    wgmma_commit();
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    wg_pin(lo);
    wg_pack<F, 0, H>(an, lo, bias);
    wgmma_wait();
    wg_pin(hi);
    wg_pin(a);
    wg_pack<F, H, H>(an, hi, bias);
  }
}
'''

LAYERS = '''    wg_layer<F, 1, false>(acc, ax, s_in);
    wg_bias_relu_pack<F>(a, acc, bias);
    for (int l = 0; l < nh; ++l) {
      wg_layer<F, F / 16, SW128>(acc, a, s_hid + uint32_t(l) * F * F * sizeof(bf16));
      wg_bias_relu_pack<F>(a, acc, bias + (l + 1) * F);
    }
'''
LAYERS_SPLIT = '''    wg_layer<F, 1, false>(acc, ax, s_in);
    wg_bias_relu_pack<F>(a, acc, bias);
    uint32_t an[F / 16][4];
    int l = 0;
    for (; l + 1 < nh; l += 2) {
      wg_layer_split<F, SW128>(acc, a, an, s_hid + uint32_t(l) * F * F * sizeof(bf16),
                               bias + (l + 1) * F);
      wg_layer_split<F, SW128>(acc, an, a, s_hid + uint32_t(l + 1) * F * F * sizeof(bf16),
                               bias + (l + 2) * F);
    }
    if (l < nh) {
      wg_layer_split<F, SW128>(acc, a, an, s_hid + uint32_t(l) * F * F * sizeof(bf16),
                               bias + (l + 1) * F);
#pragma unroll
      for (int i = 0; i < F / 16; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) a[i][j] = an[i][j];
    }
'''
KERNEL = "// out[p] = raw(p), one 64-point tile a warpgroup at a time"


def variant_sources(hdr: str) -> dict[str, str]:
    """name -> header text; every substitution must apply."""
    def sub(text, old, new):
        assert old in text, old[:60]
        return text.replace(old, new)

    def wg(text, n):
        return sub(text, "constexpr int WG_COUNT = 4;", f"constexpr int WG_COUNT = {n};")

    def split(text):
        return sub(sub(text, KERNEL, HALF_PACK + SPLIT + "\n" + KERNEL), LAYERS, LAYERS_SPLIT)

    def interleaved(text):
        return sub(text, "template <int F, bool SW128 = (F % 64 == 0)>",
                   "template <int F, bool SW128 = false>")

    def fmax_pack(text):  # relu by fmaxf, then the bf16 pack (mlp_chain.cuh's epilogue)
        return sub(text, LAYERS, LAYERS.replace("wg_bias_relu_pack<F>(", "bias_relu_pack<F>("))

    def pin_registers_only(text):  # wg_pin without the memory clobber
        text = sub(text, 'asm volatile("" : "+f"(r[i][j])::"memory");',
                   'asm volatile("" : "+f"(r[i][j]));')
        return sub(text, 'asm volatile("" : "+r"(r[i][j])::"memory");',
                   'asm volatile("" : "+r"(r[i][j]));')

    return {
        "shipped": hdr,
        "interleaved": interleaved(hdr),
        "fmax_pack": fmax_pack(hdr),
        "wg2": wg(hdr, 2),
        "wg3": wg(hdr, 3),
        "wg3_split": split(wg(hdr, 3)),
        "pin_registers_only": pin_registers_only(hdr),
    }


def nvcc() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def build(name: str, text: str) -> dict:
    d = os.path.join(OUT, name)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "mlp_wgmma.cuh"), "w") as fh:
        fh.write(text)
    shutil.copy(os.path.join(CSRC, "mlp_chain.cuh"), d)
    with open(os.path.join(d, "entry.cu"), "w") as fh:
        fh.write(ENTRY)
    so = os.path.join(d, "libvariant.so")
    p = subprocess.run([nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", so,
                        os.path.join(d, "entry.cu")], capture_output=True, text=True)
    log = p.stdout + p.stderr
    with open(os.path.join(d, "build.log"), "w") as fh:
        fh.write(log)
    regs, cur = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln and "wgmma_fwd_kernel" in ln:
            cur = ln.split("wgmma_fwd_kernelILi")[1].split("E")[0]
        elif cur and "Used" in ln:
            regs[int(cur)] = int(ln.split("Used")[1].split("registers")[0])
            cur = None
    hgmma = None
    if p.returncode == 0:
        sass = subprocess.run([os.path.join(os.path.dirname(nvcc()), "cuobjdump"), "-sass", so],
                              capture_output=True, text=True).stdout
        hgmma = sum("HGMMA" in ln for ln in sass.splitlines())
    return dict(name=name, rc=p.returncode, so=so, regs=regs, hgmma=hgmma,
                warnings=[ln for ln in log.splitlines() if "warning" in ln.lower()][:10],
                errors=log[-3000:] if p.returncode else "")


def _packed(fm, torch, nh, f, seed=0):
    from nerf_for_angiography_tpu_torch.models import CPPN, CPPNConfig

    gen = torch.Generator().manual_seed(seed)
    m = CPPN(CPPNConfig(num_early_layers=nh, num_filters=f), generator=gen)
    with torch.no_grad():
        for lin in m.linears():
            lin.bias.normal_(0.0, 0.1, generator=gen)
    return fm.pack_params(fm.cppn_params_to_list(m.to("cuda")))


def _time(torch, fn, n=20, reps=5, warmup=3) -> float:
    """Median over ``reps`` of the device ms a call with ``n`` calls enqueued
    back to back between two CUDA events (the host's issue overlaps)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b) / n)
    return statistics.median(ts)


def run_variant(so: str | None, root: str) -> dict:
    """In a fresh process: the variant in ``so`` (or, with so None, the
    package at ``root``) against the plain version, then its times."""
    import torch

    sys.path.insert(0, root)
    from nerf_for_angiography_tpu_torch.ops.kernels import fused_mlp as fm

    nsm = torch.cuda.get_device_properties(0).multi_processor_count
    if so is None:
        fwd = fm.fused_mlp_fwd_cuda
    else:
        lib = ctypes.CDLL(so)
        vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.variant_fwd.argtypes = [vp, ll, ll, ll, vp, vp, vp, vp, vp, i32, i32, vp, i32, vp]
        lib.variant_fwd.restype = i32

        def fwd(packed, x):
            out = torch.empty((x.shape[0],), device=x.device)
            code = lib.variant_fwd(
                x.data_ptr(), 3, 1, x.shape[0], packed.w_in.data_ptr(), packed.w_hid.data_ptr(),
                packed.bias.data_ptr(), packed.w_out.data_ptr(), packed.b_out.data_ptr(),
                packed.width, packed.n_hidden, out.data_ptr(), nsm,
                torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"variant launch failed: CUDA error {code}")
            return out

    def errs(packed, x):
        got, want = fwd(packed, x), fm.fused_mlp_fwd_reference(packed, x)
        s = max(1.0, float(want.abs().max()))
        e = (got - want).abs()
        return float(e.max()) / s, float(e.median()) / s, bool(torch.isfinite(got).all())

    gen = torch.Generator().manual_seed(1)
    cases, bad = 0, []
    if so is not None:
        for f in range(16, 129, 16):
            for nh in (0, 1, 4):
                packed = _packed(fm, torch, nh, f)
                for p in (50, 64 * 37 + 17):
                    x = (torch.rand((p, 3), generator=gen) * 2 - 1).cuda()
                    mx, md, fin = errs(packed, x)
                    cases += 1
                    if not (fin and mx <= FWD_MAX_REL and md <= FWD_MEDIAN_REL):
                        bad.append((f, nh, p, mx, md, fin))
    packed = _packed(fm, torch, 4, 128)
    times = {}
    for p in SHAPES:
        x = (torch.rand((p, 3), generator=torch.Generator().manual_seed(p)) * 2 - 1).cuda()
        mx, md, fin = errs(packed, x)
        if not (fin and mx <= FWD_MAX_REL and md <= FWD_MEDIAN_REL):
            bad.append((128, 4, p, mx, md, fin))
        times[p] = _time(torch, lambda: fwd(packed, x))
    return dict(cases=cases, bad=bad, ms=times)


def child(args_so: str | None, root: str) -> dict:
    cmd = [sys.executable, os.path.abspath(__file__), "--child", args_so or "-", "--root", root]
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if p.returncode != 0:
        return dict(failed=p.returncode, stderr=p.stderr[-2000:])
    return json.loads(p.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None)
    ap.add_argument("--only", default=None)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--root", default=ROOT, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(run_variant(None if args.child == "-" else args.child, args.root)))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    with open(os.path.join(CSRC, "mlp_wgmma.cuh")) as fh:
        srcs = variant_sources(fh.read())
    if args.only:
        keep = set(args.only.split(",")) | {"shipped"}
        srcs = {k: v for k, v in srcs.items() if k in keep}
    with ThreadPoolExecutor(len(srcs)) as ex:
        builds = list(ex.map(lambda kv: build(*kv), srcs.items()))
    report = {"nvidia_smi": smi, "variants": []}
    order = builds + builds[:1]  # the shipped header first and last
    for b in order:
        r = dict(b)
        if b["rc"] == 0:
            r.update(child(b["so"], ROOT))
        report["variants"].append(r)
        ms = " / ".join(f"{v:.4f}" for v in r.get("ms", {}).values())
        print(f"{b['name']}: rc {b['rc']} registers F=128 {b['regs'].get(128)} HGMMA "
              f"{b['hgmma']} cases {r.get('cases')} bad {r.get('bad')} ms at "
              f"{'/'.join(map(str, SHAPES))}: {ms} {r.get('stderr', '')}{b['errors']}",
              flush=True)
    if args.parent:
        r = child(None, os.path.abspath(args.parent))
        report["parent"] = r
        print(f"parent {args.parent}: ms " + " / ".join(f"{v:.4f}" for v in r.get("ms", {}).values())
              + f" {r.get('stderr', '')}", flush=True)
    with open(os.path.join(os.path.dirname(OUT), "fwd_variants.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
