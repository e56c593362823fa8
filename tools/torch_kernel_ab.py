#!/usr/bin/env python3
"""Time the port's kernels against other builds of the same C entries, in
one process on one card.

    python3 tools/torch_kernel_ab.py flash_attention OTHER.cu [OTHER.cu ...]
    python3 tools/torch_kernel_ab.py flash_attention_bwd OTHER.cu [...]
    python3 tools/torch_kernel_ab.py quantized_matmul OTHER.cu [OTHER.cu ...]
    python3 tools/torch_kernel_ab.py paged_attention OTHER.cu [...]
    python3 tools/torch_kernel_ab.py grouped_matmul OTHER.cu [...]
    python3 tools/torch_kernel_ab.py conv1x1_bn OTHER.cu [...]
    python3 tools/torch_kernel_ab.py layernorm_residual OTHER.cu [...]

``OTHER.cu`` is another version of ``paddle_tpu_torch/ops/csrc/<kernel>.cu``
(``fused_conv1x1_bn.cu`` for ``conv1x1_bn``, ``fused_layernorm.cu`` for
``layernorm_residual``)
with the same C entries, for example an earlier commit's
(``git show <commit>:paddle_tpu_torch/ops/csrc/flash_attention.cu >
old.cu``).  Each is built with the port's ``nvcc`` flags (and the
package's ``csrc`` on the include path, for its shared headers) beside the
package's own build ("repo"), all at once, and loaded with ctypes.  Every build is first
held against the plain PyTorch version (bf16 flash at head_dim 64 / 128 /
256, ragged S and K, offsets, with ``chip_smoke.py``'s ``FLASH_TOL``;
``quantized_matmul`` int8 bit-equal, fp8 at rtol 1e-4 / atol 1e-4 x
max|out|), then timed in turns (repo, others, others reversed, repo):

* flash: bf16 causal at the long-context slice's [2, 12, 8192, 64],
  bench.py's op [1, 8, 32768, 128] and [1, 8, 8192, 256], median of 3
  runs of CUDA events (``chip_smoke.runs_ms``), beside
  ``F.scaled_dot_product_attention``;
* flash_attention_bwd: first each build's dq and dk / dv (bf16) against
  ``flash_attention_bwd_ref`` under ``chip_smoke.py``'s ``FLASH_BWD_TOL``
  at its LT1 cases (``FLASH_BWD_CASES``) and head_dim 64 / 128 / 256, dq of
  keyless rows exactly 0; then at the same three shapes the dq kernel,
  the dk / dv kernel and the whole backward call (delta + both kernels),
  over two input copies (past the L2), beside the library's backward
  (``F.scaled_dot_product_attention`` through ``torch.autograd.grad``:
  dq, dk and dv together);
* quantized_matmul: the four linears of a gpt_small block at M = 1, 8,
  13, 40, 384, both modes, device time from a CUDA graph
  (``chip_smoke.graph_ms``), inputs rotated past the L2; then the int8
  and fp8 engines of ``chip_smoke.py`` phase Q3 on one model, each build
  in turn behind ``quantized_linear``, four times (tokens/s and mean
  latency; the phase's launch and agreement checks run every time).  The
  kernel lines add the eager call's time (``chip_smoke.time_ms``), which
  the host's per-call work bounds;
* paged_attention: every design a build holds — the first design's entry
  ``paged_flash_decode`` and, where the build has it, the split design's
  ``paged_flash_decode_split`` at splits 1, 2, 4 and 8 — against ``paged_flash_decode_ref`` at ``chip_smoke``'s
  serving geometry (T = 1, 5, 16, 48; float32 q over float, int8 and fp8
  pools; rtol 1e-4 / atol 2e-5, fully masked rows exactly 0), then timed
  at the same shapes: device time of a CUDA graph of the calls, inputs
  rotated past the L2, beside the gather + SDPA yardstick of phases 5 /
  Q4; then the float, int8, fp8 and MoE engines of phases 4, Q3 and M4,
  each build in turn behind ``paged_flash_decode``, four times (tokens/s,
  mean and p99 latency; the phases' launch and token checks run every
  time);
* grouped_matmul: the bf16 first design (entry ``grouped_matmul``) and,
  where the build has it, ``grouped_matmul_wgmma``, against ``grouped_matmul_ref`` at phase M1's slice cases (a real
  routing's group sizes and the 0 / 1 / 127 / 128 / 129 / C edges, padding
  rows NaN: exactly 0 out, two launches bit-equal, ``GMM_TOL``), then timed
  at the slice's fc1 / fc2 with the real routing (CUDA events over two
  input copies, median of 3 runs), beside ``torch.bmm``;
* conv1x1_bn: kernels 7 and 8 of every build, through the package's
  wrapper with the build's C entries swapped in, in every design the build
  holds (kernel 7: ``conv1x1_bn_stats_wgmma`` with w K-major and MN-major
  and tiles of 128 and 256 columns where the build has it, and the first
  design; kernel 8:
  ``bn_apply_relu_resident`` where the build has it, and the first
  design): held against the plain versions at ResNet-50's four conv3
  shapes (bf16) and at 1000 x 64 x 136 (``chip_smoke.stats_tolerance``,
  two calls bit-equal, both w layouts bit-equal, kernel 8 bit-equal with
  and without the residual), then timed at the four shapes by CUDA graph
  (``chip_smoke.graph_ms``, inputs rotated past the L2; the eager call,
  bounded by the wrapper's Python at layers 3-4, beside it) beside
  ``torch.mm`` (the product alone) and the bound; then ``chip_smoke.py``
  phase R3's ResNet-50 step with each build in turn behind the wrapper,
  four turns a build (ms a step, img/s; the phase's launch checks run
  every time);
* layernorm_residual: kernel 2's forward and backward in every build,
  through the package's wrapper with the build's C entries swapped in, in
  every design the build holds (forward: ``layernorm_residual_fwd_vec``
  where the build has it, and the first design; backward:
  ``layernorm_residual_bwd`` in its vector and element layouts where the
  build has it, else the plain arithmetic on the card): held against the
  plain versions (``chip_smoke.check_ln``: s exact, y / mean / rstd and
  ds / dg / db within ``chip_smoke.ln_tol``, two backward calls
  bit-equal) at BERT's, GPT's and the long-context shapes and phase W's
  [2048, 1024] in float32 and bf16, then timed there by CUDA graph
  (``chip_smoke.graph_ms``, inputs rotated past the L2; the eager call
  beside it) beside the plain versions, the library calls
  (``F.layer_norm(x + r)``; ``native_layer_norm_backward``, plus the s
  cotangent's add where the path has one) and the bounds; then
  ``chip_smoke.py`` phase 7's BERT-base step and phase LT2's long-context
  step with each build in turn behind the wrapper, two turns a build (ms a
  step; the phases' launch checks run every time, the backward count
  expected 0 behind a build without the backward kernel).

Prints one line per check and per timing, each build's ptxas register and
spill report, and the card's name and power limit first.  Exits non-zero
without a card or when a build fails a check.
"""
from __future__ import annotations

import ctypes
import importlib
import os
import re
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


def kernel_name(mangled):
    """``name<template args>`` of a mangled ``..._kernel<...>`` whose
    arguments are ints, bools, ``float`` or named types."""
    at = mangled.find("_kernelI")
    if at < 0:
        return mangled
    end = at + len("_kernel")
    # the name is preceded by its length, glued to what comes before
    start = next((j for j in range(at, 0, -1)
                  if mangled[:j].endswith(str(end - j))), None)
    if start is None:
        return mangled
    rest, out = mangled[end + 1:], []
    while rest and rest[0] != "E":
        m = re.match(r"L[ib](-?\d+)E|f|(\d+)", rest)
        if m is None:
            break
        if m.group(2):
            n = int(m.group(2))
            out.append(rest[m.end():m.end() + n])
            rest = rest[m.end() + n:]
        else:
            out.append(m.group(1) if m.group(1) is not None else "float")
            rest = rest[m.end():]
    return f"{mangled[start:end]}<{', '.join(out)}>"


def ptxas_lines(text):
    """The register, spill and wgmma-serialization lines of a build log,
    each after the kernel it is about."""
    out = []
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            out.append(kernel_name(m.group(1)))
        elif "registers" in ln or "spill" in ln or "C75" in ln:
            out.append("  " + ln.strip())
    return out


def build(srcs, workdir):
    """nvcc every source in ``srcs`` with the port's flags, all at once;
    returns {basename: (CDLL, ptxas lines)}."""
    from paddle_tpu_torch.ops import _build

    procs = {}
    for src in srcs:
        so = os.path.join(workdir, os.path.basename(src)[:-3] + ".so")
        procs[src] = (so, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o",
             so, src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    out = {}
    for src, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{src}: nvcc failed\n"
                             + "\n".join(log.splitlines()[-40:]))
        out[os.path.basename(src)] = (ctypes.CDLL(so), ptxas_lines(log))
    return out


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


def bwd_runner(lib, torch):
    """(dq, dkv) callers of a build's two backward entries, bf16."""
    tail = ([ctypes.c_int] * 4
            + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
               ctypes.c_void_p])
    fq, fkv = lib.flash_attention_bwd_dq, lib.flash_attention_bwd_dkv
    fq.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 + tail
    fkv.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 8 + tail
    fq.restype = fkv.restype = ctypes.c_int

    def dq(q, k, v, do, lse, delta, causal=True, off=0):
        B, H, S, hd = q.shape
        out = torch.empty_like(q)
        rc = fq(1, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), out.data_ptr(), B * H, S,
                k.shape[2], hd, off, int(causal), hd ** -0.5,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"flash_attention_bwd_dq: cudaError {rc}")
        return out

    def dkv(q, k, v, do, lse, delta, causal=True, off=0):
        B, H, S, hd = q.shape
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        rc = fkv(1, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), B * H, S, k.shape[2], hd, off, int(causal),
                 hd ** -0.5, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"flash_attention_bwd_dkv: cudaError {rc}")
        return dk, dv
    return dq, dkv


def bwd_calls(dq, dkv):
    """What is timed for one build, on a (q, k, v, do, out, lse, delta)
    copy: the dq kernel, the dk / dv kernel, the whole backward call."""
    def call(q, k, v, do, o, lse, _):
        delta = (do.float() * o.float()).sum(-1)
        return dq(q, k, v, do, lse, delta), dkv(q, k, v, do, lse, delta)

    return (lambda q, k, v, do, o, lse, d: dq(q, k, v, do, lse, d),
            lambda q, k, v, do, o, lse, d: dkv(q, k, v, do, lse, d), call)


def flash_bwd(torch, cs, runs):
    import torch.nn.functional as F

    fa = importlib.import_module("paddle_tpu_torch.ops.flash_attention")
    gen = torch.Generator().manual_seed(cs.SEED + 42)
    for tag, (dq, dkv) in runs.items():
        for hd in (64, 128, 256):
            for S, K, causal, off in cs.FLASH_BWD_CASES:
                q, k, v, do, out, lse = cs.bwd_inputs(
                    torch, fa, 2, 3, S, K, hd, torch.bfloat16, gen, causal,
                    off)
                delta = (do.float() * out.float()).sum(-1)
                got = (dq(q, k, v, do, lse, delta, causal, off),
                       *dkv(q, k, v, do, lse, delta, causal, off))
                ref = fa.flash_attention_bwd_ref(q, k, v, out, lse, do,
                                                 causal, q_position_offset=off)
                torch.cuda.synchronize()
                shares = [cs.grad_close(torch, g, r, "bfloat16")[1]
                          for g, r in zip(got, ref)]
                assert bool(torch.all(got[0][torch.isneginf(lse)] == 0))
                print(f"check {tag} bwd bf16 hd={hd} S={S} K={K} causal="
                      f"{causal} offset={off}: dq / dk / dv "
                      f"{' / '.join(f'{x:.3f}' for x in shares)} of the "
                      f"tolerance; ok", flush=True)
    order = list(runs) + list(runs)[::-1]
    for name, (B, H, S, hd) in FLASH_SHAPES:
        copies = []
        for _ in range(2):
            q, k, v, do, out, lse = cs.bwd_inputs(torch, fa, B, H, S, S, hd,
                                                  torch.bfloat16, gen)
            copies.append((q, k, v, do, out, lse,
                           (do.float() * out.float()).sum(-1)))
        pairs = B * H * (S * (S + 1) // 2)
        iters = max(3, int(3e13 // (14.0 * pairs * hd)))
        got = {}
        for tag in order:
            got.setdefault(tag, []).append(tuple(
                cs.runs_ms(torch, fn, copies, iters)[0]
                for fn in bwd_calls(*runs[tag])))
        graphs = []
        for q, k, v, do, *_ in copies:
            ins = tuple(t.detach().requires_grad_() for t in (q, k, v))
            graphs.append((F.scaled_dot_product_attention(
                *ins, is_causal=True), ins, do))
        lib = cs.runs_ms(torch, lambda o, ins, do: torch.autograd.grad(
            o, ins, do, retain_graph=True), graphs, iters)[0]
        for tag, ms in got.items():
            print(f"time flash bwd bf16 causal {name} [{B}, {H}, {S}, {hd}] "
                  f"{tag}: dq {' / '.join(f'{t[0]:.4f}' for t in ms)} ms "
                  f"({6.0 * pairs * hd / min(t[0] for t in ms) / 1e9:.1f} "
                  f"TFLOP/s), dk/dv {' / '.join(f'{t[1]:.4f}' for t in ms)} "
                  f"ms ({8.0 * pairs * hd / min(t[1] for t in ms) / 1e9:.1f}"
                  f" TFLOP/s), call {' / '.join(f'{t[2]:.4f}' for t in ms)} "
                  f"ms (SDPA backward {lib:.4f} ms)", flush=True)
        del copies, graphs


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


def paged_runners(lib, torch):
    """{design: caller} of a build's paged entries (the wrapper's
    arguments): the first design, and the split design at several splits
    and ring depths where the build has it."""
    from paddle_tpu_torch.ops import paged_attention as pa

    tail = [ctypes.c_float, ctypes.c_void_p]
    first = lib.paged_flash_decode
    first.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
                      + [ctypes.c_int] * 8 + tail)
    first.restype = ctypes.c_int

    def head(q, k, v, tab, mask, ks, vs):
        B, H, T, hd = q.shape
        out = torch.empty_like(q)
        codes = (pa._DTYPES[q.dtype],
                 pa._QUANT_DTYPES.get(k.dtype, pa._DTYPES.get(k.dtype)))
        return out, (*codes, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     None if ks is None else ks.data_ptr(),
                     None if vs is None else vs.data_ptr(), tab.data_ptr(),
                     mask.view(torch.uint8).data_ptr(), out.data_ptr(), B,
                     H, T, hd, k.shape[2])

    def call_first(q, k, v, tab, mask, ks=None, vs=None):
        out, args = head(q, k, v, tab, mask, ks, vs)
        rc = first(*args, k.shape[2], tab.shape[1], k.shape[0],
                   q.shape[3] ** -0.5,
                   torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"paged_flash_decode: cudaError {rc}")
        return out

    runs = {"first design": call_first}
    if not hasattr(lib, "paged_flash_decode_split"):
        return runs
    split = lib.paged_flash_decode_split
    split.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
                      + [ctypes.c_int] * 7 + [ctypes.c_float]
                      + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    split.restype = ctypes.c_int

    def split_run(S):
        def run(q, k, v, tab, mask, ks=None, vs=None):
            out, args = head(q, k, v, tab, mask, ks, vs)
            rc = split(*args, tab.shape[1], k.shape[0], q.shape[3] ** -0.5,
                       S, pa._tile_rows(q.shape[2], q.shape[3]),
                       torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"paged_flash_decode_split: cudaError "
                                   f"{rc}")
            return out
        return run

    for S in (1, 2, 4, 8):
        runs[f"split {S}"] = split_run(S)
    return runs


def paged(torch, cs, runs):
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import paged_attention as pa

    def library(q, k, v, tab, mask, ks=None, vs=None):
        # chip_smoke's phase 5 / Q4 yardstick: gather (and dequantize),
        # then PyTorch's fused attention
        def view(pool, sc):
            x = pool[tab.long()]
            if sc is not None:
                x = x.float() * sc[tab.long()][..., None]
            return x.permute(0, 2, 1, 3, 4).reshape(cs.B, cs.H,
                                                    cs.G * cs.PAGE, cs.HD)
        return F.scaled_dot_product_attention(
            q, view(k, ks), view(v, vs), attn_mask=mask[:, None])

    gen = torch.Generator().manual_seed(cs.SEED + 50)
    pools = {"float": None, "int8": torch.int8, "fp8": torch.float8_e4m3fn}
    for pool, qdt in pools.items():
        for T in (1, 5, 16, 48):
            q, kv, tab, mask, _ = cs.geometry(torch, T, torch.float32, gen,
                                              n_copies=4)
            args = []
            for kp, vp in kv:
                extra = (() if qdt is None else
                         cs.quantize_pools(torch, kp, vp, qdt))
                args.append((q, *(extra[:2] or (kp, vp)), tab, mask,
                             *extra[2:]))
            del kv
            ref = pa.paged_flash_decode_ref(*args[0])
            dead = ~mask.any(-1)
            for tag, designs in runs.items():
                for name, fn in designs.items():
                    out = fn(*args[0])
                    torch.cuda.synchronize()
                    torch.testing.assert_close(out, ref, rtol=1e-4,
                                               atol=2e-5)
                    assert not bool(out.permute(0, 2, 1, 3)[dead].any())
            got = {}
            for tag in list(runs) + list(runs)[::-1]:
                for name, fn in runs[tag].items():
                    got.setdefault((tag, name), []).append(
                        cs.graph_ms(torch, fn, args, 50))
            lib = cs.graph_ms(torch, library, args, 20)
            for (tag, name), ms in got.items():
                print(f"time paged_flash_decode {pool} pool, f32 q, T={T} "
                      f"(checked) {tag} {name}: "
                      f"{' / '.join(f'{t:.4f}' for t in ms)} ms (gather + "
                      f"SDPA {lib:.4f} ms)", flush=True)
            del args


def paged_engines(torch, cs, libs):
    """Phase 4's float engine, phase Q3's int8 / fp8 engines and phase M4's
    MoE engine, each build in turn behind ``paged_flash_decode`` (the
    repo's as the wrapper plans it; another build through its split entry
    where it has one, else its first design), four turns a build: how much
    of the kernel's time reaches tokens/s."""
    from paddle_tpu_torch.ops import paged_attention as pa

    def entry(lib, symbol, argtypes):
        fn = getattr(lib, symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int

        def call(*args):
            rc = fn(*args)
            if rc:
                raise RuntimeError(f"{symbol}: cudaError {rc}")
        return call

    first_types = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p])
    split_types = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 7 + [ctypes.c_float]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    gpu = cs.gpu_line()
    own = (pa._kernel_fn(), pa._split_kernel_fn(), pa._plan)
    swaps = {"repo": own}
    for tag, lib in libs.items():
        if tag == "repo":
            continue
        if hasattr(lib, "paged_flash_decode_split"):
            swaps[tag] = (entry(lib, "paged_flash_decode", first_types),
                          entry(lib, "paged_flash_decode_split",
                                split_types), pa._plan)
        else:
            swaps[tag] = (entry(lib, "paged_flash_decode", first_types),
                          None, lambda B, H, T, hd, page, *_:
                          ("first", pa._page_chunk(page, hd)))
    order = (list(swaps) + list(swaps)[::-1]) * 2
    model = cs.build_serve_model(torch)
    try:
        for name in ("float", "int8", "fp8", "moe"):
            if name == "moe":  # the dense model is no longer needed
                del model
                model = cs.moe_model(torch, "float32",
                                     moe_capacity_factor=cs.MOE_SERVE_CF)
            got = {}
            for tag in order:
                pa._fn, pa._split_fn, pa._plan = swaps[tag]
                r = cs.serve(torch, gpu, model,
                             quantized=name if name in ("int8", "fp8")
                             else None)
                got.setdefault(tag, []).append(
                    (r["tokens_per_s"], r["mean_ms"], r["p99_ms"]))
            for tag, vals in got.items():
                print(f"serve {name} {tag}: " + " / ".join(
                    f"{tps:.1f} tokens/s ({ms:.1f} ms mean, {p99:.1f} ms "
                    f"p99)" for tps, ms, p99 in vals), flush=True)
    finally:
        pa._fn, pa._split_fn, pa._plan = own


def gmm_runners(lib, torch):
    """{design: caller} of a build's bf16 grouped-matmul entries."""
    first = lib.grouped_matmul
    first.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                      + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    first.restype = ctypes.c_int

    def out_of(x, w):
        return torch.empty(x.shape[0], x.shape[1], w.shape[2],
                           dtype=x.dtype, device=x.device)

    def call_first(x, w, gs):
        y = out_of(x, w)
        rc = first(1, x.data_ptr(), w.data_ptr(), gs.data_ptr(),
                   y.data_ptr(), *x.shape, w.shape[2],
                   torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"grouped_matmul: cudaError {rc}")
        return y

    runs = {"first design": call_first}
    if not hasattr(lib, "grouped_matmul_wgmma"):
        return runs
    wg = lib.grouped_matmul_wgmma
    wg.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    wg.restype = ctypes.c_int

    def wgmma(x, w, gs):
        y = out_of(x, w)
        rc = wg(x.data_ptr(), w.data_ptr(), gs.data_ptr(), y.data_ptr(),
                *x.shape, w.shape[2], torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"grouped_matmul_wgmma: cudaError {rc}")
        return y

    runs["wgmma"] = wgmma
    return runs

def gmm(torch, cs, runs):
    from paddle_tpu_torch.ops.grouped_matmul import grouped_matmul_ref

    gen = torch.Generator().manual_seed(cs.SEED + 51)
    gs_train, C = cs.routed_group_sizes(torch, cs.MOE_B * cs.MOE_S,
                                        torch.bfloat16, 1.25, cs.SEED + 40)
    edges = torch.tensor([0, 1, 127, 128, 129, C, C - 1, 2047],
                         dtype=torch.int32, device="cuda")
    for name, D, F in (("fc1", 768, 3072), ("fc2", 3072, 768)):
        for gs in (gs_train.int(), edges):
            x, w, g = cs.gmm_inputs(torch, cs.MOE_E, C, D, F, gs,
                                    torch.bfloat16, gen)
            valid = (torch.arange(C, device="cuda")[None, :]
                     < g.clamp(0, C)[:, None])
            x[~valid] = float("nan")
            ref = grouped_matmul_ref(x, w, g)
            rel, floor = cs.GMM_TOL["bfloat16"]
            allowed = rel * ref.float().abs() + floor * float(
                ref.float().pow(2).mean().sqrt())
            for tag, designs in runs.items():
                for dname, fn in designs.items():
                    y, y2 = fn(x, w, g), fn(x, w, g)
                    torch.cuda.synchronize()
                    assert torch.equal(y, y2), (tag, dname)
                    assert not bool(y[~valid].any()), (tag, dname)
                    err = (y.float() - ref.float()).abs()
                    assert bool((err <= allowed).all()), (tag, dname)
                    print(f"check {tag} {dname} {name} gs={g.tolist()}: "
                          f"max_abs_err={float(err.max()):.3e}; padding "
                          f"rows 0, two launches bit-equal; ok", flush=True)
            del x, w
        args = [cs.gmm_inputs(torch, cs.MOE_E, C, D, F, gs_train.int(),
                              torch.bfloat16, gen) for _ in range(2)]
        flops = 2.0 * float(gs_train.clamp(0, C).sum()) * D * F
        got = {}
        for tag in list(runs) + list(runs)[::-1]:
            for dname, fn in runs[tag].items():
                got.setdefault((tag, dname), []).append(
                    cs.runs_ms(torch, fn, args, 50)[0])
        lib = cs.runs_ms(torch, lambda x, w, g: torch.bmm(x, w), args, 50)[0]
        for (tag, dname), ms in got.items():
            print(f"time grouped_matmul bf16 {name} [{cs.MOE_E}, {C}, {D}] x "
                  f"[{cs.MOE_E}, {D}, {F}] (checked) {tag} {dname}: "
                  f"{' / '.join(f'{t:.4f}' for t in ms)} ms = "
                  f"{flops / min(ms) / 1e9:.1f} TFLOP/s (torch.bmm "
                  f"{lib:.4f} ms)", flush=True)
        del args


def conv_bn_entries(lib):
    """{C entry: caller} of the build's entries that the wrapper calls."""
    from paddle_tpu_torch.ops import fused_conv1x1_bn as fcb

    out = {}
    for symbol, argtypes in fcb._ARGTYPES.items():
        if not hasattr(lib, symbol):
            continue
        fn = getattr(lib, symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int

        def call(*args, fn=fn, symbol=symbol):
            rc = fn(*args)
            if rc:
                raise RuntimeError(f"{symbol}: cudaError {rc}")
        out[symbol] = call
    return out


def conv_bn(torch, cs, libs):
    from paddle_tpu_torch.ops import fused_conv1x1_bn as fcb

    swaps = {tag: conv_bn_entries(lib) for tag, lib in libs.items()}
    own = (dict(fcb._fns), fcb._stats_plan, fcb._apply_plan)

    def first_stats(x, w):
        return "first", "mn-major" if w.is_contiguous() else "copy"

    def use(tag):
        """The wrapper on ``tag``'s build: the build's entries, and the
        first designs alone where it has no Hopper entry."""
        fcb._fns.clear()
        fcb._fns.update(swaps[tag])
        fcb._stats_plan = (own[1] if "conv1x1_bn_stats_wgmma" in swaps[tag]
                           else first_stats)
        fcb._apply_plan = (own[2] if "bn_apply_relu_resident" in swaps[tag]
                           else lambda *a: "first")

    def designs(tag):
        """([(name, w K-major?, design, tile_n)], [bn_apply designs])"""
        k7 = ([(f"wgmma {layout} {tile}", layout == "k-major", None, tile)
               for tile in (128, 256) for layout in ("k-major", "mn-major")]
              if "conv1x1_bn_stats_wgmma" in swaps[tag] else [])
        k8 = ["resident"] if "bn_apply_relu_resident" in swaps[tag] else []
        return k7 + [("first", False, "first", None)], k8 + ["first"]

    def graph_ms(fn, args, iters):
        # the first design of an older build sets its shared-memory limit
        # on every launch, which a CUDA graph capture may refuse
        try:
            return cs.graph_ms(torch, fn, args, iters)
        except RuntimeError as err:
            print(f"graph capture failed ({str(err)[:120]})", flush=True)
            torch.cuda.synchronize()
            return float("nan")

    gpu = cs.gpu_line()
    gen = torch.Generator().manual_seed(cs.SEED + 61)
    try:
        for name, M, K, N in cs.RESNET_TAILS + (("edge", 1000, 64, 136),):
            x, w, gamma, beta, res = cs.resnet_tail_inputs(
                torch, "bfloat16", M, K, N, gen)
            wk = w.t().contiguous().t()  # ResNet's layout: [N, K] storage
            y0, s0, q0 = fcb.conv1x1_bn_stats_ref(x, w)
            yf_abs = (x.float() @ w.float()).abs().sum(0)
            _, _, _, scale, shift = fcb._fold(s0, q0, M, gamma, beta, 1e-5,
                                              y0.dtype)
            for tag in swaps:
                use(tag)
                k7, k8 = designs(tag)
                got = {}
                for dname, kmajor, design, tile in k7:
                    ww = wk if kmajor else w
                    a = fcb._stats_kernel(x, ww, design=design, tile_n=tile)
                    b = fcb._stats_kernel(x, ww, design=design, tile_n=tile)
                    torch.cuda.synchronize()
                    assert all(torch.equal(u, v) for u, v in zip(a, b)), \
                        (tag, dname, name)
                    e = cs.stats_tolerance(torch, a[0], y0, a[1], s0, a[2],
                                           q0, yf_abs, "bfloat16")
                    got[dname] = a
                    print(f"check {tag} conv1x1_bn_stats {dname} {name}: y "
                          f"max_abs_err={e[0]:.3e}, sum {e[1]:.2e}, sumsq "
                          f"{e[2]:.2e}; two calls bit-equal; ok", flush=True)
                for tile in (128, 256):
                    if f"wgmma k-major {tile}" in got:
                        assert all(torch.equal(u, v) for u, v in zip(
                            got[f"wgmma k-major {tile}"],
                            got[f"wgmma mn-major {tile}"])), (tag, name)
                        print(f"check {tag} conv1x1_bn_stats {name}: "
                              f"{tile}-column tiles, w K-major and MN-major "
                              f"bit-equal; ok", flush=True)
                for design in k8:
                    for r in (res, None):
                        out = fcb._apply_kernel(y0, scale, shift, r,
                                                design=design)
                        want = fcb.bn_apply_relu_ref(y0, scale, shift, r)
                        torch.cuda.synchronize()
                        assert torch.equal(out, want), (tag, design, name)
                    print(f"check {tag} bn_apply_relu {design} {name}: "
                          f"bit-equal to plain with and without the "
                          f"residual; ok", flush=True)
                del got
            del x, w, wk, res, y0, yf_abs

        order = list(swaps) + list(swaps)[::-1]
        with torch.no_grad():
            for name, M, K, N in cs.RESNET_TAILS:
                per_call = 2 * (M * K + K * N + M * N)
                n_copies = max(2, -(-120_000_000 // per_call))
                ins = [cs.resnet_tail_inputs(torch, "bfloat16", M, K, N, gen)
                       for _ in range(n_copies)]
                iters = max(10, min(100, int(2e10 // (M * N))))
                b7 = max(per_call / cs.HBM_BYTES_PER_S,
                         2.0 * M * K * N / cs.BF16_FLOPS) * 1e3
                b8 = (6 * M * N + 8 * N) / cs.HBM_BYTES_PER_S * 1e3
                k8_args = []
                for x, w, gamma, beta, res in ins:
                    y, s, q = fcb.conv1x1_bn_stats_ref(x, w)
                    _, _, _, scale, shift = fcb._fold(s, q, M, gamma, beta,
                                                      1e-5, y.dtype)
                    k8_args.append((y, scale, shift, res))
                got = {}
                for tag in order:
                    use(tag)
                    k7, k8 = designs(tag)
                    for dname, kmajor, design, tile in k7:
                        args = [(x, w.t().contiguous().t() if kmajor else w)
                                for x, w, _, _, _ in ins]

                        def call(x, w, design=design, tile=tile):
                            return fcb._stats_kernel(x, w, design=design,
                                                     tile_n=tile)
                        got.setdefault(("conv1x1_bn_stats", tag, dname),
                                       []).append((
                                           graph_ms(call, args, iters),
                                           cs.time_ms(torch, call, args,
                                                      iters)))
                        del args
                    for design in k8:
                        def call(*a, design=design):
                            return fcb._apply_kernel(*a, design=design)
                        got.setdefault(("bn_apply_relu", tag, design),
                                       []).append((
                                           graph_ms(call, k8_args, iters),
                                           cs.time_ms(torch, call, k8_args,
                                                      iters)))
                mm_args = [(x, w) for x, w, _, _, _ in ins]
                mm = (graph_ms(torch.mm, mm_args, iters),
                      cs.time_ms(torch, torch.mm, mm_args, iters))
                for (kernel, tag, dname), vals in got.items():
                    bound = b7 if kernel == "conv1x1_bn_stats" else b8
                    print(f"time {kernel} bf16 {name} [{M}, {K}] @ [{K}, "
                          f"{N}] (checked) {tag} {dname}: graph "
                          f"{' / '.join(f'{g:.4f}' for g, _ in vals)} ms, "
                          f"eager {' / '.join(f'{e:.4f}' for _, e in vals)} "
                          f"ms (bound {bound:.4f}"
                          + (f"; torch.mm graph {mm[0]:.4f}, eager "
                             f"{mm[1]:.4f}" if kernel == "conv1x1_bn_stats"
                             else "") + ")", flush=True)
                del ins, k8_args, mm_args
                torch.cuda.empty_cache()

        steps = {}
        for tag in order * 2:
            use(tag)
            r = cs.train_resnet(torch, gpu)
            steps.setdefault(tag, []).append((r["step_ms"], r["img_per_s"]))
            torch.cuda.empty_cache()
        for tag, vals in steps.items():
            print(f"resnet50 step (R3) {tag}: " + " / ".join(
                f"{ms:.2f} ms ({ips:.1f} img/s)" for ms, ips in vals),
                flush=True)
    finally:
        fcb._fns.clear()
        fcb._fns.update(own[0])
        fcb._stats_plan, fcb._apply_plan = own[1], own[2]


def ln_entries(lib):
    """{C entry: caller} of the build's entries that the wrapper calls."""
    from paddle_tpu_torch.ops import fused_layernorm as fl

    out = {}
    for symbol, argtypes in fl._ARGTYPES.items():
        if not hasattr(lib, symbol):
            continue
        fn = getattr(lib, symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int

        def call(*args, fn=fn, symbol=symbol):
            rc = fn(*args)
            if rc:
                raise RuntimeError(f"{symbol}: cudaError {rc}")
        out[symbol] = call
    return out


def layernorm(torch, cs, libs):
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import fused_layernorm as fl

    swaps = {tag: ln_entries(lib) for tag, lib in libs.items()}
    own = (dict(fl._fns), fl._forward_plan, fl._backward_plan)

    def use(tag):
        """The wrapper on ``tag``'s build: its entries, the first forward
        design alone where it has no Hopper entry, the plain backward where
        it has no backward kernel; occupancies asked of this build."""
        fl._fns.clear()
        fl._fns.update(swaps[tag])
        fl._occupancy.clear()
        fl._forward_plan = (own[1] if "layernorm_residual_fwd_vec"
                            in swaps[tag] else lambda *a: "first")
        fl._backward_plan = (own[2] if "layernorm_residual_bwd" in swaps[tag]
                             else lambda *a: "plain")

    def designs(tag):
        fwd = (["vector"] if "layernorm_residual_fwd_vec" in swaps[tag]
               else []) + ["first"]
        bwd = (["vector", "scalar"] if "layernorm_residual_bwd" in swaps[tag]
               else [])
        return fwd, bwd

    gpu = cs.gpu_line()
    shapes = [(name, dtype, M, D, has) for name, dtype, M, D, has
              in cs.LN_SHAPES] + [("wide", dtype, *cs.WIDE_LN, True)
                                  for dtype in ("float32", "bfloat16")]
    order = list(swaps) + list(swaps)[::-1]
    try:
        for name, dtype, M, D, _ in shapes:
            for tag in swaps:
                use(tag)
                print(f"check {tag} {name}:", flush=True)
                cs.check_ln(torch, fl, dtype, M, D,
                            torch.Generator().manual_seed(cs.SEED + 71))
        with torch.no_grad():
            for name, dtype, M, D, has_ds in shapes:
                gen = torch.Generator().manual_seed(cs.SEED + 72)
                item = torch.finfo(getattr(torch, dtype)).bits // 8
                args = cs.ln_inputs(torch, dtype, M, D, gen,
                                    n_copies=cs.ln_copies(M, D, item))
                bargs, largs = [], []
                for x, r, g, b in args:
                    s, _, mean, rstd = fl._forward_ref(x, r, g, b, 1e-5)
                    dy, ds = (torch.randn(M, D, generator=gen).to(
                        "cuda", s.dtype) for _ in range(2))
                    ds_out = ds if has_ds else None
                    bargs.append((s, mean, rstd, g, ds_out, dy))
                    largs.append(cs.ln_library_bwd(torch, s, g, b, dy,
                                                   ds_out))
                got = {}
                for tag in order:
                    use(tag)
                    fwd, bwd = designs(tag)
                    for design in fwd:
                        def call(*a, design=design):
                            return fl._forward_kernel(*a, 1e-5,
                                                      design=design)
                        got.setdefault(("forward", tag, design), []).append(
                            (cs.graph_ms(torch, call, args, 100),
                             cs.time_ms(torch, call, args, 100)))
                    for design in bwd:
                        def call(*a, design=design):
                            return fl._backward_kernel(*a, design=design)
                        got.setdefault(("backward", tag, design), []).append(
                            (cs.graph_ms(torch, call, bargs, 50),
                             cs.time_ms(torch, call, bargs, 50)))
                use("repo")
                plain = (cs.graph_ms(torch, lambda *a: fl._forward_ref(
                    *a, 1e-5), args, 20),
                    cs.graph_ms(torch, fl._backward_ref, bargs, 10))
                lib = (cs.graph_ms(torch, lambda x, r, g, b: F.layer_norm(
                    x + r, (D,), g, b, 1e-5), args, 50),
                    cs.graph_ms(torch, lambda i: largs[i][0](*largs[i][1]),
                                [(i,) for i in range(len(largs))], 50))
                bound = (cs.ln_bound(M, D, item)[0],
                         cs.ln_bwd_bound(M, D, item, has_ds)[0])
                for (way, tag, design), vals in got.items():
                    k = way == "backward"
                    print(f"time layernorm_residual {way} {name} {dtype} "
                          f"[{M}, {D}]"
                          f"{' with the s cotangent' if k and has_ds else ''}"
                          f" (checked) {tag} {design}: graph "
                          f"{' / '.join(f'{g:.4f}' for g, _ in vals)} ms, "
                          f"eager {' / '.join(f'{e:.4f}' for _, e in vals)} "
                          f"ms ({100 * bound[k] / min(g for g, _ in vals):.0f}"
                          f"% of the bound {bound[k]:.4f}; plain graph "
                          f"{plain[k]:.4f}, library graph {lib[k]:.4f})",
                          flush=True)
                del args, bargs, largs
                torch.cuda.empty_cache()

        steps = {}
        for tag in order:
            use(tag)
            kernel = "layernorm_residual_bwd" in swaps[tag]
            bert = cs.train_bert(torch, gpu, ln_backward_kernel=kernel)
            torch.cuda.empty_cache()
            long = cs.long_context_training(torch, gpu,
                                            ln_backward_kernel=kernel)
            torch.cuda.empty_cache()
            steps.setdefault(tag, []).append((bert["step_ms"],
                                              long["step_ms"]))
        for tag, vals in steps.items():
            print(f"steps {tag}: BERT (phase 7) " + " / ".join(
                f"{b:.2f}" for b, _ in vals) + " ms, long context (LT2) "
                + " / ".join(f"{t:.2f}" for _, t in vals) + " ms a step",
                flush=True)
    finally:
        fl._fns.clear()
        fl._fns.update(own[0])
        fl._occupancy.clear()
        fl._forward_plan, fl._backward_plan = own[1], own[2]


def main() -> int:
    import torch

    if not torch.cuda.is_available() or len(sys.argv) < 3 or \
            sys.argv[1] not in ("flash_attention", "flash_attention_bwd",
                                "quantized_matmul", "paged_attention",
                                "grouped_matmul", "conv1x1_bn",
                                "layernorm_residual"):
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    import chip_smoke as cs
    from paddle_tpu_torch.ops import _build

    kernel, others = sys.argv[1], sys.argv[2:]
    source = {"conv1x1_bn": "fused_conv1x1_bn",
              "layernorm_residual": "fused_layernorm"}.get(kernel, kernel)
    print(cs.gpu_line(), flush=True)
    libs = {"repo": (_build.load(source), ptxas_lines(
        _build.library_path(source).with_suffix(".log").read_text()))}
    with tempfile.TemporaryDirectory() as tmp:
        libs.update(build(others, tmp))
        for tag, (_, ptxas) in libs.items():
            for ln in ptxas:
                print(f"ptxas {tag}: {ln}")
        if kernel == "flash_attention":
            flash(torch, cs, {tag: flash_runner(lib, torch)
                              for tag, (lib, _) in libs.items()})
        elif kernel == "flash_attention_bwd":
            flash_bwd(torch, cs, {tag: bwd_runner(lib, torch)
                                  for tag, (lib, _) in libs.items()})
        elif kernel == "paged_attention":
            paged(torch, cs, {tag: paged_runners(lib, torch)
                              for tag, (lib, _) in libs.items()})
            paged_engines(torch, cs, {tag: lib
                                      for tag, (lib, _) in libs.items()})
        elif kernel == "grouped_matmul":
            gmm(torch, cs, {tag: gmm_runners(lib, torch)
                            for tag, (lib, _) in libs.items()})
        elif kernel == "conv1x1_bn":
            conv_bn(torch, cs, {tag: lib for tag, (lib, _) in libs.items()})
        elif kernel == "layernorm_residual":
            layernorm(torch, cs, {tag: lib for tag, (lib, _) in libs.items()})
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
