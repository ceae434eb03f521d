#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100::

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's failure is caught):

1. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` (nvcc,
   in parallel) and print the build time and ptxas' register report;
2. the main path, through the user entry points: ``compress_amr`` of the
   ``run1_z10`` structure at 512³ (two levels, 23/77, seed 10) with
   ``eb = 1e-3 · range`` of the finest level → ``write`` → ``read`` →
   ``read_roi``, all on ``cuda``.  Decoded levels must equal the
   compress-time recon bit for bit, the ROI crops must equal slices of
   them, and ``max|recon − orig|`` over each mask must stay within
   ``eb + 2⁻²²·max|orig|``.  Kernel launch counts are reset just before
   and read just after; every kernel must have launched;
3. kernels 1-4 against their plain PyTorch versions on the card, at the
   main path's shapes (exact agreement required), with CUDA-event times
   of the kernel, the plain version and, where one PyTorch call computes
   the same function, that call (``library_ms``, a yardstick only).  The
   plain Huffman decoder walks the finest level's payloads of at most
   16,384 symbols (plus a truncated copy of one); the kernel is timed on
   the whole level;
4. the TAC path (``she=False``), through the user entry points: the
   ``run2_t3`` structure (Nyx Run2_T3, three levels 2/6/92 %, seed 3) at
   512³ with ``eb = 1e-3 · range`` of the finest level, compressed with
   each of ``lorenzo``, ``lor_reg`` and ``interp``.  The 92 % coarse level
   must take GSP, every level must hold the error bound, and that level
   streamed through ``TACZWriter(strategy="gsp")`` must read back
   (``read``, ``read_roi``, ``verify``) equal to the compress-time recon.
   Launch counts are reset before and read after; kernels 5 and 6 must
   have launched.  Kernels 5 and 6 are then held against their plain
   versions, and timed, on the grid that path gives them: the GSP-padded
   128³ coarse level.  There a launch is about as short as the host's
   cost per call, so they are also timed from a CUDA graph of 100 calls;
5. kernels 5 and 6 against their plain versions on the GSP-padded finest
   level of phase 2's snapshot (512³), at ``tile = shape`` and at the
   reference's default tile ``(8, 128, 128)``.

Prints the card's name and power limit, the script's wall time, a
``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": {...}}``.
Without a CUDA device, or outside a checkout, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src")

SHAPE = (512, 512, 512)
DENSITIES = [0.23, 0.77]
TAC_DENSITIES = [0.0202, 0.0556, 0.9242]     # run2_t3: fine → coarse
TAC_ALGORITHMS = ("lorenzo", "lor_reg", "interp")
ROI_BOX = ((100, 228), (200, 264), (0, 512))
PLAIN_K4_MAX_SYMBOLS = 16384
HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3
FP32_OPS_PER_S = 67e12           # H100 SXM, outside the tensor cores

KERNELS = {
    "lorenzo3d_codes_batched": ("src/repro_torch/kernels/csrc/lorenzo3d.cu",
                                "src/repro/kernels/lorenzo3d.py:139"),
    "lorenzo3d_recon_batched": ("src/repro_torch/kernels/csrc/lorenzo3d.cu",
                                "src/repro/kernels/lorenzo3d.py:157"),
    "hist": ("src/repro_torch/kernels/csrc/hist.cu",
             "src/repro/kernels/hist.py:41"),
    "huffdec": ("src/repro_torch/kernels/csrc/huffdec.cu",
                "src/repro/kernels/huffdec.py:48"),
    "lorenzo3d_codes": ("src/repro_torch/kernels/csrc/lorenzo3d.cu",
                        "src/repro/kernels/lorenzo3d.py:64"),
    "lorenzo3d_recon": ("src/repro_torch/kernels/csrc/lorenzo3d.cu",
                        "src/repro/kernels/lorenzo3d.py:82"),
}


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, reps: int, torch) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int, torch) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls captured in one
    CUDA graph, so the host's cost per launch, which exceeds a small
    kernel's own time, drops out."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main() -> int:
    t_start = time.perf_counter()
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        return fail("run from a checkout: src/repro_torch is missing")
    import torch
    if not torch.cuda.is_available():
        return fail("no CUDA device available")
    sys.path.insert(0, SRC)
    import numpy as np

    from repro_torch import io as tio
    from repro_torch.core import amr, gsp, hybrid
    from repro_torch.core.entropy import TorchEngine
    from repro_torch.kernels import build, ops, ref

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    dev = torch.device("cuda")

    # ---------------------------------------------------------- 1. build
    t0 = time.perf_counter()
    build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    for name, log in build.build_logs().items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # ---------------------------------------------------------- 2. main path
    t0 = time.perf_counter()
    ds = amr.synthetic_amr(SHAPE, densities=DENSITIES, refine_block=16,
                           lognormal_sigma=1.8, seed=10)
    fine = ds.levels[0]
    vals = fine.data[fine.mask]
    eb = 1e-3 * float(vals.max() - vals.min())
    print(f"data: {SHAPE} levels={ds.n_levels} eb={eb:.6g} "
          f"gen {time.perf_counter() - t0:.1f} s")

    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    stages = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "snap.tacz")
        t0 = time.perf_counter()
        res = hybrid.compress_amr(ds, eb=eb, device="cuda")
        torch.cuda.synchronize()
        stages["compress_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tio.write(path, res, device="cuda")
        stages["write_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        levels = tio.read(path, device="cuda")
        torch.cuda.synchronize()
        stages["read_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        roi = tio.read_roi(path, ROI_BOX, device="cuda")
        torch.cuda.synchronize()
        stages["read_roi_s"] = time.perf_counter() - t0
        launches = dict(ops.launches)
        file_bytes = os.path.getsize(path)
        with tio.TACZReader(path, device="cuda") as rd:
            check(rd.verify(), "container CRCs")
            entry0 = rd.levels[0]
            jobs = [(sb, tuple(sb.size), None) for sb in entry0.subblocks]
            parts = [rd._payload_parts(0, sb, shape) for sb, shape, _ in jobs]
            payloads0 = [(cb, sb.nbits, sb.n_codes)
                         for (cb, _), sb in zip(parts, entry0.subblocks)]
            codebook0 = rd._codebook(0)
    peak = torch.cuda.max_memory_allocated()

    for li, (lr, got) in enumerate(zip(res.levels, levels)):
        check(torch.equal(got, lr.recon), f"level {li}: read != recon")
        lvl = ds.levels[li]
        orig = torch.from_numpy(lvl.data).to(dev)
        mask = torch.from_numpy(lvl.mask).to(dev)
        err = float((got - orig).abs()[mask].max())
        limit = lr.eb + 2.0 ** -22 * float(orig.abs().max())
        check(err <= limit, f"level {li}: max err {err} > {limit}")
        print(f"level {li}: strategy={lr.strategy} subblocks={lr.n_subblocks} "
              f"values={lr.n_values} max_err={err:.6g} limit={limit:.6g}")
    for c in roi:
        want = levels[c.level][tuple(slice(lo, hi) for lo, hi in c.box)]
        check(torch.equal(c.data, want), f"roi level {c.level} != slice")
    raw_bytes = 4 * res.n_values
    print("main path: " + json.dumps({
        "card": smi, **{k: round(v, 3) for k, v in stages.items()},
        "compression_ratio_bits": res.compression_ratio(),
        "compression_ratio_file": raw_bytes / file_bytes,
        "file_bytes": file_bytes, "peak_device_bytes": peak,
        "launches": launches}))
    for name in ("lorenzo3d_codes_batched", "lorenzo3d_recon_batched",
                 "hist", "huffdec"):
        check(launches[name] > 0,
              f"kernel {name} never launched on the main path")

    # ------------------------------------------------- 3. kernels vs plain
    rows = []

    def row(name, err, ms, plain_ms, bytes_moved, ops_count, library_ms,
            n_launches=None):
        b_ms, b_by = bound(bytes_moved, ops_count)
        rows.append({"name": name, "route": "cuda",
                     "source": KERNELS[name][0], "replaces": KERNELS[name][1],
                     "launches": (launches[name] if n_launches is None
                                  else n_launches), "max_abs_err": err,
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": library_ms})
        print(f"kernel {name}: ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}) library_ms={library_ms} "
              f"max_abs_err={err} [{smi}]")

    # K1/K2 on the largest same-shape stack of the finest level
    grid, _, _, subblocks = hybrid.partition_level(
        fine.data, fine.mask, unit=8)
    groups: dict = {}
    for sb in subblocks:
        groups.setdefault(tuple(sb.cell_size(grid.unit)), []).append(sb)
    shape, sbs = max(groups.items(),
                     key=lambda kv: len(kv[1]) * int(np.prod(kv[0])))
    u = grid.unit
    x = torch.from_numpy(np.stack([
        grid.data[tuple(slice(o * u, o * u + s) for o, s
                        in zip(sb.origin, shape))] for sb in sbs])).to(dev)
    n_el = x.numel()
    print(f"K1/K2 stack: {len(sbs)} x {shape}")
    codes = ops.lorenzo3d_codes_batched(x, eb)
    plain = ref.lorenzo3d_codes_batched(x, eb)
    check(torch.equal(codes, plain), "K1 != plain")
    row("lorenzo3d_codes_batched", 0,
        cuda_ms(lambda: ops.lorenzo3d_codes_batched(x, eb), 20, torch),
        cuda_ms(lambda: ref.lorenzo3d_codes_batched(x, eb), 5, torch),
        12 * n_el, 12 * n_el, None)
    recon = ops.lorenzo3d_recon_batched(codes, eb)
    plain_r = ref.lorenzo3d_recon_batched(codes, eb)
    check(torch.equal(recon, plain_r), "K2 != plain")
    row("lorenzo3d_recon_batched", float((recon - plain_r).abs().max()),
        cuda_ms(lambda: ops.lorenzo3d_recon_batched(codes, eb), 20, torch),
        cuda_ms(lambda: ref.lorenzo3d_recon_batched(codes, eb), 5, torch),
        12 * n_el, 5 * n_el, None)
    del x, codes, plain, recon, plain_r

    # K3 on the finest level's pooled codes
    pooled = torch.cat([r.codes for r in res.levels[0].artifacts.results])
    lo, hi = (int(v) for v in torch.aminmax(pooled))
    span = hi - lo + 1
    counts = ops.hist(pooled, lo, span)
    check(torch.equal(counts, ref.hist(pooled, lo, span)), "K3 != plain")
    check(torch.equal(counts, torch.bincount(pooled - lo, minlength=span)),
          "K3 != bincount")
    shifted = pooled - lo
    row("hist", 0,
        cuda_ms(lambda: ops.hist(pooled, lo, span), 20, torch),
        cuda_ms(lambda: ref.hist(pooled, lo, span), 5, torch),
        8 * pooled.numel() + 8 * span, 2 * pooled.numel(),
        cuda_ms(lambda: torch.bincount(shifted, minlength=span), 20, torch))
    print(f"K3 input: {pooled.numel()} codes, span {span}")
    del pooled, shifted, counts

    # K4 against its plain version on the finest level's payloads of at
    # most PLAIN_K4_MAX_SYMBOLS symbols plus a truncated copy of the longest
    # of them (the plain lockstep decoder runs one step per symbol of the
    # longest payload); the whole level is checked by phase 2's read
    eng = TorchEngine(dev)
    short = [p for p in payloads0 if p[2] <= PLAIN_K4_MAX_SYMBOLS]
    trunc = max(short, key=lambda p: p[2])
    short = short + [(trunc[0], trunc[1] // 2, trunc[2])]
    sargs = eng.huffdec_args(codebook0, short)
    out_k, err_k = ops.huffdec(*sargs)
    t0 = time.perf_counter()
    out_p, err_p = ref.huffdec(*sargs)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(torch.equal(out_k, out_p) and torch.equal(err_k, err_p),
          "K4 != plain on the level's payloads")
    check(int(err_k[-1]) == 1 and not bool(err_k[:-1].any()),
          "K4 error kinds on the level's payloads")
    print(f"K4 plain check: {len(short)} payloads, {sargs[5]} symbols, "
          f"max {trunc[2]} per payload, plain {plain_ms:.1f} ms")
    # ... and an incomplete codebook with valid, corrupt and truncated ones
    from repro_torch.core import huffman
    cb_gap = huffman._canonicalize(np.array([5, -3], np.int64),
                                   np.array([1, 2], np.int64))  # 0, 10; 11 free
    gap = [(np.packbits([0, 1, 0, 0, 1, 0]), 6, 4),
           (np.packbits([0, 1, 1, 0, 0, 0]), 6, 3),
           (np.packbits([0, 1]), 2, 2)]
    gargs = eng.huffdec_args(cb_gap, gap)
    gk, ek = ops.huffdec(*gargs)
    gp, ep = ref.huffdec(*gargs)
    check(torch.equal(gk, gp) and torch.equal(ek, ep), "K4 != plain (gap)")
    check(ek.tolist() == [0, 2, 1], f"K4 gap error kinds {ek.tolist()}")
    # K4 timed on the whole level's payloads plus a truncated one
    payloads = payloads0 + [(payloads0[0][0], payloads0[0][1] // 2,
                             payloads0[0][2])]
    args = eng.huffdec_args(codebook0, payloads)
    n_out = args[5]
    walked_bits = sum(min(nb, 8 * len(b)) for b, nb, _ in payloads)
    row("huffdec", 0, cuda_ms(lambda: ops.huffdec(*args), 3, torch), plain_ms,
        int(args[0].numel()) + 8 * n_out + 36 * len(payloads),
        walked_bits * 4, None)
    print(f"K4 input: {len(payloads)} payloads, {n_out} symbols, "
          f"max {max(p[2] for p in payloads)} per payload")

    del payloads0, payloads, args, sargs, res, levels, roi

    # ---------------------------------------------------------- 4. TAC path
    t0 = time.perf_counter()
    ds4 = amr.synthetic_amr(SHAPE, densities=TAC_DENSITIES, refine_block=16,
                            lognormal_sigma=2.6, seed=3)
    vals = ds4.levels[0].data[ds4.levels[0].mask]
    eb4 = 1e-3 * float(vals.max() - vals.min())
    coarse_li = ds4.n_levels - 1
    coarse = ds4.levels[coarse_li]
    print(f"TAC data: {SHAPE} levels={ds4.n_levels} "
          f"densities={[round(l.density, 4) for l in ds4.levels]} "
          f"eb={eb4:.6g} gen {time.perf_counter() - t0:.1f} s")
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    tac = {}
    with tempfile.TemporaryDirectory() as tmp:
        for alg in TAC_ALGORITHMS:
            st = {}
            t0 = time.perf_counter()
            res4 = hybrid.compress_amr(ds4, eb=eb4, algorithm=alg, she=False,
                                       device="cuda")
            torch.cuda.synchronize()
            st["compress_s"] = time.perf_counter() - t0
            check(res4.method == f"tac/{alg}", f"{alg}: method {res4.method}")
            for li, lr in enumerate(res4.levels):
                lvl = ds4.levels[li]
                orig = torch.from_numpy(lvl.data).to(dev)
                mask = torch.from_numpy(lvl.mask).to(dev)
                err = float((lr.recon - orig).abs()[mask].max())
                limit = lr.eb + 2.0 ** -22 * float(orig.abs().max())
                check(err <= limit, f"{alg} level {li}: max err {err} > "
                                    f"{limit}")
                print(f"{alg} level {li}: strategy={lr.strategy} "
                      f"density={lr.density:.4f} subblocks={lr.n_subblocks} "
                      f"bits={lr.total_bits} max_err={err:.6g} "
                      f"limit={limit:.6g}")
                del orig, mask
            check(res4.levels[coarse_li].strategy == "gsp",
                  f"{alg}: coarse level took "
                  f"{res4.levels[coarse_li].strategy}, not gsp")
            recon_c = res4.levels[coarse_li].recon
            path = os.path.join(tmp, f"{alg}.tacz")
            t0 = time.perf_counter()
            with tio.TACZWriter(path, eb=eb4, algorithm=alg, she=False,
                                strategy="gsp", device="cuda") as w:
                w.add_level(coarse.data, coarse.mask, ratio=coarse.ratio)
            st["write_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            got, = tio.read(path, device="cuda")
            torch.cuda.synchronize()
            st["read_s"] = time.perf_counter() - t0
            check(torch.equal(got, recon_c), f"{alg}: read != recon")
            t0 = time.perf_counter()
            crop, = tio.read_roi(path, ROI_BOX, device="cuda")
            torch.cuda.synchronize()
            st["read_roi_s"] = time.perf_counter() - t0
            check(torch.equal(crop.data, got[tuple(
                slice(lo, hi) for lo, hi in crop.box)]), f"{alg}: roi")
            with tio.TACZReader(path, device="cuda") as rd:
                check(rd.verify(), f"{alg}: container CRCs")
            st["compression_ratio_bits"] = res4.compression_ratio()
            st["coarse_file_bytes"] = os.path.getsize(path)
            tac[alg] = (st, path)
            del res4, recon_c, got, crop
        launches4 = dict(ops.launches)
        peak4 = torch.cuda.max_memory_allocated()
        for alg, (st, path) in tac.items():
            # K4 on the level's one GSP payload (after the counts were read)
            with tio.TACZReader(path, device="cuda") as rd:
                sb = rd.levels[0].subblocks[0]
                code_bytes, _ = rd._payload_parts(0, sb, rd.subblock_shape(0, 0))
                gargs = eng.huffdec_args(rd._codebook(0),
                                         [(code_bytes, sb.nbits, sb.n_codes)])
            st["k4_gsp_payload_ms"] = cuda_ms(lambda: ops.huffdec(*gargs), 2,
                                              torch)
            st["gsp_payload_symbols"] = sb.n_codes
            print(f"TAC {alg}: " + json.dumps({"card": smi, **{
                k: (round(v, 4) if isinstance(v, float) else v)
                for k, v in st.items()}}))
    print("TAC path: " + json.dumps({"peak_device_bytes": peak4,
                                     "launches": launches4}))
    for name in ("lorenzo3d_codes", "lorenzo3d_recon"):
        check(launches4[name] > 0,
              f"kernel {name} never launched on the TAC path")

    # K5/K6 against their plain versions on the grid the TAC path gives
    # them: the GSP-padded coarse level, at the path's tile = shape
    padded, _ = gsp.gsp_pad(coarse.data, coarse.mask,
                            unit=max(2, 8 // coarse.ratio), device=dev)
    gshape = tuple(padded.shape)
    for tile in (gshape, (8, 128, 128)):
        codes = ops.lorenzo3d_codes(padded, eb4, tile)
        check(torch.equal(codes, ref.lorenzo3d_codes(padded, eb4, tile)),
              f"K5 != plain on the TAC path's grid at tile {tile}")
        recon = ops.lorenzo3d_recon(codes, eb4, tile)
        check(torch.equal(recon, ref.lorenzo3d_recon(codes, eb4, tile)),
              f"K6 != plain on the TAC path's grid at tile {tile}")
    n_el = padded.numel()
    tac_grid = {"card": smi, "shape": gshape, "values": n_el,
                "zero_share": float((padded == 0).sum()) / n_el}
    tac_grid["bound_ms"] = bound(12 * n_el, 12 * n_el)[0]
    tac_grid["k5_ms"] = cuda_ms(
        lambda: ops.lorenzo3d_codes(padded, eb4, gshape), 200, torch)
    tac_grid["k5_plain_ms"] = cuda_ms(
        lambda: ref.lorenzo3d_codes(padded, eb4, gshape), 20, torch)
    tac_grid["k6_ms"] = cuda_ms(
        lambda: ops.lorenzo3d_recon(codes, eb4, gshape), 200, torch)
    tac_grid["k6_plain_ms"] = cuda_ms(
        lambda: ref.lorenzo3d_recon(codes, eb4, gshape), 20, torch)
    tac_grid["k5_graph_ms"] = graph_ms(
        lambda: ops.lorenzo3d_codes(padded, eb4, gshape), 100, torch)
    tac_grid["k6_graph_ms"] = graph_ms(
        lambda: ops.lorenzo3d_recon(codes, eb4, gshape), 100, torch)
    print("K5/K6 == plain on the TAC path's GSP grid at both tiles: "
          + json.dumps(tac_grid))
    del padded, codes, recon

    # ------------------------------------------------- 5. K5/K6 vs plain
    padded, _ = gsp.gsp_pad(fine.data, fine.mask, unit=8, device=dev)
    n_el = padded.numel()
    print(f"K5/K6 input: GSP-padded finest level of phase 2, "
          f"{tuple(padded.shape)}, {n_el} values, zero share "
          f"{float((padded == 0).sum()) / n_el}")
    for tile in (SHAPE, (8, 128, 128)):
        codes = ops.lorenzo3d_codes(padded, eb, tile)
        check(torch.equal(codes, ref.lorenzo3d_codes(padded, eb, tile)),
              f"K5 != plain at tile {tile}")
        recon = ops.lorenzo3d_recon(codes, eb, tile)
        check(torch.equal(recon, ref.lorenzo3d_recon(codes, eb, tile)),
              f"K6 != plain at tile {tile}")
        print(f"K5/K6 == plain at tile {tile}")
        del codes, recon
    codes = ops.lorenzo3d_codes(padded, eb, SHAPE)
    row("lorenzo3d_codes", 0,
        cuda_ms(lambda: ops.lorenzo3d_codes(padded, eb, SHAPE), 20, torch),
        cuda_ms(lambda: ref.lorenzo3d_codes(padded, eb, SHAPE), 3, torch),
        12 * n_el, 12 * n_el, None, launches4["lorenzo3d_codes"])
    row("lorenzo3d_recon", 0,
        cuda_ms(lambda: ops.lorenzo3d_recon(codes, eb, SHAPE), 20, torch),
        cuda_ms(lambda: ref.lorenzo3d_recon(codes, eb, SHAPE), 3, torch),
        12 * n_el, 5 * n_el, None, launches4["lorenzo3d_recon"])
    del padded, codes

    print(f"total wall: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
