#!/usr/bin/env python3
"""Time the port's flash-attention forward or quantized_matmul against other
builds of the same C entry, in one process on one card.

    python3 tools/torch_kernel_ab.py flash_attention OTHER.cu [OTHER.cu ...]
    python3 tools/torch_kernel_ab.py quantized_matmul OTHER.cu [OTHER.cu ...]

``OTHER.cu`` is another version of ``paddle_tpu_torch/ops/csrc/<kernel>.cu``
with the same C entry, for example an earlier commit's
(``git show <commit>:paddle_tpu_torch/ops/csrc/flash_attention.cu >
old.cu``).  Each is built with the port's ``nvcc`` flags beside the
package's own build ("repo") and loaded with ctypes.  Every build is first
held against the plain PyTorch version (bf16 flash at head_dim 64 / 128 /
256, ragged S and K, offsets, with ``chip_smoke.py``'s ``FLASH_TOL``;
``quantized_matmul`` int8 bit-equal, fp8 at rtol 1e-4 / atol 1e-4 x
max|out|), then timed in turns (repo, others, others reversed, repo):

* flash: bf16 causal at the long-context slice's [2, 12, 8192, 64],
  bench.py's op [1, 8, 32768, 128] and [1, 8, 8192, 256], median of 3
  runs of CUDA events (``chip_smoke.runs_ms``), beside
  ``F.scaled_dot_product_attention``;
* quantized_matmul: the four linears of a gpt_small block at M = 1, 8,
  13, 40, 384, both modes, device time from a CUDA graph
  (``chip_smoke.graph_ms``), inputs rotated past the L2; then the int8
  and fp8 engines of ``chip_smoke.py`` phase Q3 on one model, each build
  in turn behind ``quantized_linear``, four times (tokens/s and mean
  latency; the phase's launch and agreement checks run every time).  The
  kernel lines add the eager call's time (``chip_smoke.time_ms``), which
  the host's per-call work bounds.

Prints one line per check and per timing, each build's ptxas register and
spill report, and the card's name and power limit first.  Exits non-zero
without a card or when a build fails a check.
"""
from __future__ import annotations

import ctypes
import importlib
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

FLASH_CASES = ((1, 1, True, 0), (127, 127, True, 0), (129, 300, False, 0),
               (1000, 1000, True, 0), (777, 1290, True, 517),
               (513, 400, True, -130))
FLASH_SHAPES = (("slice", (2, 12, 8192, 64)),
                ("bench_op", (1, 8, 32768, 128)),
                ("hd256", (1, 8, 8192, 256)))
QMM_M = (1, 8, 13, 40, 384)


def build(src, workdir):
    """nvcc ``src`` with the port's flags; returns (CDLL, ptxas lines)."""
    from paddle_tpu_torch.ops import _build

    so = os.path.join(workdir, os.path.basename(src)[:-3] + ".so")
    r = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", so, src],
                       capture_output=True, text=True)
    log = (r.stdout + r.stderr).splitlines()
    if r.returncode:
        raise SystemExit(f"{src}: nvcc failed\n" + "\n".join(log[-40:]))
    keep = [ln.strip() for ln in log
            if "registers" in ln or "spill" in ln or "C75" in ln]
    return ctypes.CDLL(so), keep


def flash_runner(lib, torch):
    f = lib.flash_attention_fwd
    f.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                  + [ctypes.c_int] * 4
                  + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                     ctypes.c_void_p])
    f.restype = ctypes.c_int

    def run(q, k, v, causal=True, off=0):
        B, H, S, hd = q.shape
        out = torch.empty_like(q)
        lse = torch.empty(B, H, S, device=q.device)
        rc = f(1, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
               lse.data_ptr(), B * H, S, k.shape[2], hd, off, int(causal),
               hd ** -0.5, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"flash_attention_fwd: cudaError {rc}")
        return out, lse
    return run


def qmm_entry(lib):
    """The C entry as ``quantized_matmul``'s wrapper calls it."""
    f = lib.quantized_matmul
    f.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                  + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    f.restype = ctypes.c_int

    def call(*args):
        rc = f(*args)
        if rc:
            raise RuntimeError(f"quantized_matmul: cudaError {rc}")
    return call


def qmm_runner(lib, torch, dtypes):
    f = qmm_entry(lib)

    def run(xq, wq, scale, bias):
        M, K = xq.shape
        N = wq.shape[1]
        out = torch.empty(M, N, device=xq.device)
        f(dtypes[wq.dtype], xq.data_ptr(), wq.data_ptr(), scale.data_ptr(),
          bias.data_ptr(), out.data_ptr(), M, K, N,
          torch.cuda.current_stream().cuda_stream)
        return out
    return run


def flash(torch, cs, runs):
    import torch.nn.functional as F

    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    gen = torch.Generator().manual_seed(cs.SEED + 40)
    for tag, run in runs.items():
        for hd in (64, 128, 256):
            for S, K, causal, off in FLASH_CASES:
                q, k, v = cs.flash_inputs(torch, 2, 3, S, K, hd,
                                          torch.bfloat16, gen)
                out, lse = run(q, k, v, causal, off)
                ref, rlse = fa.flash_attention_fwd_lse_ref(
                    q, k, v, causal, q_position_offset=off)
                torch.cuda.synchronize()
                err, ratio = cs.flash_out_close(torch, out, ref, "bfloat16")
                dead = torch.isneginf(rlse)
                assert torch.equal(torch.isneginf(lse), dead)
                assert bool(torch.all(out[dead] == 0))
                torch.testing.assert_close(lse[~dead], rlse[~dead],
                                           **cs.FLASH_LSE_TOL["bfloat16"])
                print(f"check {tag} bf16 hd={hd} S={S} K={K} causal="
                      f"{causal} offset={off}: max_abs_err={err:.3e}, "
                      f"{ratio:.3f} of the tolerance; ok", flush=True)
    order = list(runs) + list(runs)[::-1]
    for name, (B, H, S, hd) in FLASH_SHAPES:
        args = [cs.flash_inputs(torch, B, H, S, S, hd, torch.bfloat16, gen)]
        flops = 4.0 * B * H * (S * (S + 1) // 2) * hd
        iters = max(3, int(2e13 // flops))
        got = {}
        for tag in order:
            got.setdefault(tag, []).append(cs.runs_ms(
                torch, lambda q, k, v, r=runs[tag]: r(q, k, v), args,
                iters)[0])
        lib = cs.runs_ms(torch, lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), args, iters)[0]
        for tag, ms in got.items():
            print(f"time flash bf16 causal {name} [{B}, {H}, {S}, {hd}] "
                  f"{tag}: {' / '.join(f'{t:.4f}' for t in ms)} ms = "
                  f"{flops / min(ms) / 1e9:.1f} TFLOP/s (SDPA {lib:.4f} ms)",
                  flush=True)
        del args


def qmm(torch, cs, runs):
    qm = importlib.import_module("paddle_tpu_torch.ops.quantized_matmul")
    gen = torch.Generator().manual_seed(cs.SEED + 41)
    for mode in cs.QUANT_MODES:
        for name, (K, N) in cs.QMM_KN.items():
            for M in QMM_M:
                args = [a[:4] for a in cs.qmm_inputs(
                    torch, mode, M, K, N, gen,
                    n_copies=-(-64_000_000 // (K * N)))]
                ref = qm._matmul_ref(*args[0])
                for tag, run in runs.items():
                    out = run(*args[0])
                    torch.cuda.synchronize()
                    if mode == "int8":
                        assert torch.equal(out, ref), (tag, name, M)
                    else:
                        torch.testing.assert_close(
                            out, ref, rtol=1e-4,
                            atol=1e-4 * float(ref.abs().max()))
                got, eager = {}, {}
                for tag in list(runs) + list(runs)[::-1]:
                    got.setdefault(tag, []).append(
                        cs.graph_ms(torch, runs[tag], args, 100))
                    eager.setdefault(tag, []).append(
                        cs.time_ms(torch, runs[tag], args, 200))
                def fmt(ts):
                    return " / ".join(f"{t:.4f}" for t in ts)
                print(f"time quantized_matmul {mode} {name} [{M}, {K}] @ "
                      f"[{K}, {N}] (checked): " + ", ".join(
                          f"{tag} {fmt(ms)} ms (eager calls "
                          f"{fmt(eager[tag])})"
                          for tag, ms in got.items()), flush=True)
                del args


def qmm_engines(torch, cs, entries):
    """Phase Q3's engines with each build behind ``quantized_linear``."""
    qm = importlib.import_module("paddle_tpu_torch.ops.quantized_matmul")
    gpu = cs.gpu_line()
    model = cs.build_serve_model(torch)
    own = qm._kernel_fn()
    order = (list(entries) + list(entries)[::-1]) * 2
    try:
        for mode in cs.QUANT_MODES:
            got = {}
            for tag in order:
                qm._fn = own if tag == "repo" else entries[tag]
                r = cs.serve(torch, gpu, model, quantized=mode)
                got.setdefault(tag, []).append(
                    (r["tokens_per_s"], r["mean_ms"]))
            for tag, vals in got.items():
                print(f"serve {mode} {tag}: " + " / ".join(
                    f"{tps:.1f} tokens/s ({ms:.1f} ms mean latency)"
                    for tps, ms in vals), flush=True)
    finally:
        qm._fn = own


def main() -> int:
    import torch

    if not torch.cuda.is_available() or len(sys.argv) < 3 or \
            sys.argv[1] not in ("flash_attention", "quantized_matmul"):
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle_tpu_torch.ops import _build

    kernel, others = sys.argv[1], sys.argv[2:]
    print(cs.gpu_line(), flush=True)
    libs = {"repo": (_build.load(kernel), [
        ln.strip() for ln in _build.library_path(kernel).with_suffix(
            ".log").read_text().splitlines()
        if "registers" in ln or "spill" in ln or "C75" in ln])}
    with tempfile.TemporaryDirectory() as tmp:
        for src in others:
            libs[os.path.basename(src)] = build(src, tmp)
        for tag, (_, ptxas) in libs.items():
            for ln in ptxas:
                print(f"ptxas {tag}: {ln}")
        if kernel == "flash_attention":
            flash(torch, cs, {tag: flash_runner(lib, torch)
                              for tag, (lib, _) in libs.items()})
        else:
            qm = importlib.import_module(
                "paddle_tpu_torch.ops.quantized_matmul")
            qmm(torch, cs, {tag: qmm_runner(lib, torch, qm._DTYPES)
                            for tag, (lib, _) in libs.items()})
            qmm_engines(torch, cs, {
                tag: None if tag == "repo" else qmm_entry(lib)
                for tag, (lib, _) in libs.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
