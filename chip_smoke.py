"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`) on one GPU.

    python3 chip_smoke.py          # from the root of a repository checkout

Phases, in order; any failure raises and the script exits non-zero:

  1. The card: name and power limit as nvidia-smi reports them.
  2. Build the CUDA kernels from `src/repro_torch/kernels/csrc` (nvcc,
     sm_90a) into `build/repro_torch_kernels/`, and print the build time
     and ptxas's register / shared-memory report.
  3. Hold each kernel against its plain PyTorch version at the full-width
     internlm2-1.8b decode shapes (8 rows, 16/8/128 heads, block 16, fp32
     q, bf16 pages, ragged positions, one all-trash row; plus fp32
     pages), and time kernel, plain version and a PyTorch library call
     with CUDA events, beside the bytes/operations bound.
  4. The main path: a full-width internlm2-1.8b M_S -> M_L cascade on the
     paged backend with the kernels on, through `build_ladder`,
     `ContinuousCascadeEngine.calibrate` and `.run`, with the launch
     counters reset just before and checked just after; plus one
     full-width decode step, kernel path against plain path, by logits.
  5. The reduced fp32 fixture, kernel path against plain path (identical
     greedy tokens per request), and `launch.serve.main()` with defaults.

The last two lines of standard output are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result,
when no CUDA device is present or the repository's sources are missing.
"""
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

H100_BYTES_PER_S = 3.35e12       # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12          # fp32 outside the tensor cores

# main-path configuration (full width, one card)
ARCH = "internlm2-1.8b"
N_SLOTS, BLOCK, CHUNK = 8, 16, 128
N_REQUESTS, RAGGED, MAX_NEW, DEFERRAL = 16, (64, 256), 32, 0.3
SEED = 0
DEV = "cuda"
SLEEP_CYCLES = 200_000_000      # ~0.1 s of GPU clock ahead of each timing

# tolerances
DECODE_ATOL = 1e-4     # fp32 accumulation in both, summed in other orders
STEP_LOGIT_ATOL = 1e-3  # one full-width decode step with fp32 activations
                        # over the bf16 cache: fp32 rounding through 24 layers
STEP_LOGIT_GUARD = 0.2  # the same step with the main config's bf16
                        # activations: a last-bit difference after the fp32
                        # attention can flip a bf16 rounding of the residual
                        # stream. Sound readings on an H100 were 0.053 and
                        # 0.064; the guard is about 3x the larger


def _fail_early(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    raise SystemExit(2)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds per call of `fn`: CUDA events around
    `iters` calls. A sleep kernel queued first keeps the GPU busy while
    the host enqueues the calls, so host launch overhead is hidden and
    the calls run back to back."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_FP32_FLOPS * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def decode_case(torch, kv_dtype, rng):
    """Full-width decode inputs: 8 rows, ragged positions, row 7 unmapped.
    The table is as wide as the main path's widest active prefix, and one
    row sits at the last position the main path reaches. `R` rotating page
    copies exceed the 50 MB L2, so timed launches read their pages from
    device memory as the decode loop does (24 layers of weights pass
    through L2 between two visits of one layer's cache)."""
    B, H, KV, hd, bs = N_SLOTS, 16, 8, 128, BLOCK
    M = math.ceil((RAGGED[1] + MAX_NEW) / bs)        # 18 blocks per row
    pos = [70, RAGGED[1] + MAX_NEW - 1, 130, 200, 96, 180, 240, 150]
    n_map = [math.ceil((p + 1) / bs) for p in pos]
    n_map[-1] = 0                                    # the all-trash row
    N = N_SLOTS * M
    perm = rng.permutation(N) + 1
    tables = torch.zeros((B, M), dtype=torch.int32)
    used = 0
    for b, n in enumerate(n_map):
        tables[b, :n] = torch.from_numpy(perm[used:used + n].astype("int32"))
        used += n
    dev = DEV
    q = torch.randn((B, 1, H, hd), device=dev)
    R = 8
    pages = [(torch.randn((N + 1, bs, KV, hd), device=dev).to(kv_dtype),
              torch.randn((N + 1, bs, KV, hd), device=dev).to(kv_dtype))
             for _ in range(R)]
    valid_tokens = sum(min(p + 1, n * bs) for p, n in zip(pos, n_map))
    # table entries the decode reads: those of blocks 0 .. pos // bs
    table_entries = sum(min(M, math.ceil((p + 1) / bs)) for p in pos)
    return dict(q=q, pages=pages, tables=tables.to(dev),
                pos=torch.tensor(pos, dtype=torch.int32, device=dev),
                valid_tokens=valid_tokens, table_entries=table_entries,
                B=B, H=H, KV=KV, hd=hd, M=M, N=N)


class Rotation:
    """Cycles through input copies, one per call."""

    def __init__(self, items):
        self.items, self.i = items, 0

    def __call__(self):
        self.i = (self.i + 1) % len(self.items)
        return self.items[self.i]


def check_decode_kernel(torch, pa, c, kv_name, smi) -> dict:
    """paged_flash_decode_gqa against its plain version; times both and
    SDPA. Returns the kernel's record."""
    q, tables, pos = c["q"], c["tables"], c["pos"]
    kp, vp = c["pages"][0]
    out = pa.paged_flash_decode_gqa(q, kp, vp, tables, pos)
    ref = pa.paged_flash_decode_gqa_plain(q, kp, vp, tables, pos)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    if not (torch.isfinite(out).all() and err <= DECODE_ATOL):
        raise AssertionError(f"paged_flash_decode_gqa ({kv_name} pages) "
                             f"max |err| {err} > {DECODE_ATOL}")
    if out[-1].abs().max() != 0:
        raise AssertionError("all-trash row is not exact zeros")
    pages = Rotation(c["pages"])
    ms = time_ms(lambda: pa.paged_flash_decode_gqa(q, *pages(), tables, pos))
    plain_ms = time_ms(lambda: pa.paged_flash_decode_gqa_plain(
        q, *pages(), tables, pos))
    # yardstick only, never called by the port: SDPA over the pre-gathered
    # bf16 view, K/V heads expanded to the query heads beforehand
    S, group = c["M"] * BLOCK, c["H"] // c["KV"]
    mask = ((torch.arange(S, device=DEV)[None, :] <= pos[:, None])
            & (tables.repeat_interleave(BLOCK, 1) > 0))[:, None, None, :]
    idx = tables.long().reshape(-1)
    views = Rotation([tuple(
        t[idx].reshape(c["B"], S, c["KV"], c["hd"]).transpose(1, 2)
        .repeat_interleave(group, dim=1).to(torch.bfloat16) for t in pg)
        for pg in c["pages"]])
    qb = q.transpose(1, 2).to(torch.bfloat16)
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qb, *views(), attn_mask=mask))
    n_bytes = (2 * c["valid_tokens"] * c["KV"] * c["hd"] * kp.element_size()
               + 2 * q.numel() * q.element_size() + 4 * c["table_entries"]
               + 4 * pos.numel())
    flops = 4 * c["valid_tokens"] * c["H"] * c["hd"]
    bound_ms, bound_by = bound(n_bytes, flops)
    print(f"[kernel] paged_flash_decode_gqa q fp32, pages {kv_name}: "
          f"max|err| {err:.3g} (atol {DECODE_ATOL}), all-trash row exact 0; "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa(gathered) "
          f"{lib_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}: {n_bytes} B,"
          f" {flops} fp32 flop) on {smi}")
    return dict(name="paged_flash_decode_gqa", route="cuda",
                source="src/repro_torch/kernels/csrc/paged_attention.cu",
                replaces="src/repro/kernels/paged_attention.py:106",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms)


def check_write_kernel(torch, pa, c, kv_name, kv_dtype, smi) -> dict:
    """paged_write_token (fp32 values into the leaf, in place) against its
    plain version, bit for bit outside the trash block; times both and
    `index_put_`. Returns the kernel's record."""
    tables, pos = c["tables"], c["pos"]
    vals = torch.randn((c["B"], c["KV"], c["hd"]), device=DEV)
    leaves = [pg[0].clone() for pg in c["pages"]]
    ref = pa.paged_write_token_plain(leaves[0].clone(), tables, pos, vals)
    got = pa.paged_write_token(leaves[0], tables, pos, vals)
    torch.cuda.synchronize()
    err = float((got[1:].float() - ref[1:].float()).abs().max())
    if err != 0:
        raise AssertionError(f"paged_write_token ({kv_name} leaf) is not "
                             f"bit-exact outside block 0: {err}")
    leaf = Rotation(leaves)
    ms = time_ms(lambda: pa.paged_write_token(leaf(), tables, pos, vals))
    plain_ms = time_ms(lambda: pa.paged_write_token_plain(
        leaf(), tables, pos, vals))
    blk = torch.clamp(pos.long() // BLOCK, 0, c["M"] - 1)
    phys = tables.long().gather(1, blk[:, None])[:, 0]
    off = pos.long() % BLOCK
    vcast = vals.to(kv_dtype)
    lib_ms = time_ms(lambda: leaf().index_put_((phys, off), vcast))
    n_bytes = (vals.numel() * (4 + leaves[0].element_size())
               + 4 * c["B"] + 4 * pos.numel())   # one table entry per row
    bound_ms, bound_by = bound(n_bytes, 0)
    print(f"[kernel] paged_write_token fp32 -> {kv_name} leaf: bit-exact "
          f"outside block 0; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"index_put_ {lib_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}: "
          f"{n_bytes} B) on {smi}")
    return dict(name="paged_write_token", route="cuda",
                source="src/repro_torch/kernels/csrc/paged_attention.cu",
                replaces="src/repro/kernels/paged_attention.py:250",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=lib_ms)


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        _fail_early(f"no repro_torch sources under {SRC}: run from the "
                    f"root of a repository checkout")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        _fail_early("torch.cuda.is_available() is False: this script "
                    "needs an NVIDIA GPU")
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build
    from repro_torch.kernels import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 matmuls in fp32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # -- 1. the card -------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"(tf32 matmul {torch.backends.cuda.matmul.allow_tf32})")

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"[build] {len(libs)} kernel librar{'y' if len(libs) == 1 else 'ies'}"
          f" in {time.perf_counter() - t0:.1f} s")
    for lib in libs:
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "Compiling entry" in line:
                print(f"[build] {line.strip()}")

    rng = np.random.default_rng(SEED)
    records = {}
    with torch.inference_mode():
        # -- 3. kernels against their plain versions -------------------------
        for kv_name, kv_dtype in (("bf16", torch.bfloat16),
                                  ("fp32", torch.float32)):
            case = decode_case(torch, kv_dtype, rng)
            rec_d = check_decode_kernel(torch, pa, case, kv_name, smi)
            rec_w = check_write_kernel(torch, pa, case, kv_name, kv_dtype, smi)
            if kv_name == "bf16":                # the main path's types
                records["paged_flash_decode_gqa"] = rec_d
                records["paged_write_token"] = rec_w
            del case
        torch.cuda.empty_cache()

        # -- 4. the main path at full width ---------------------------------
        from repro_torch.data.synthetic import (make_lm_stream,
                                                make_ragged_lm_stream)
        from repro_torch.launch import serve
        from repro_torch.models import transformer as tfm
        from repro_torch.serving import (CascadeSpec, ContinuousCascadeEngine,
                                         EngineConfig, PagedConfig,
                                         make_requests)
        from repro_torch.serving.request import DONE

        t0 = time.perf_counter()
        small, large = serve.build_ladder(ARCH, SEED, 2, reduce=False,
                                          device=DEV)
        torch.cuda.synchronize()
        cfg = small.cfg
        n_params = [sum(t.numel() for t in _leaves(r.params))
                    for r in (small, large)]
        print(f"[main] {cfg.name}: {cfg.n_layers} layers d_model "
              f"{cfg.d_model} {cfg.n_heads}/{cfg.n_kv_heads} heads hd "
              f"{cfg.head_dim} d_ff {cfg.d_ff} vocab {cfg.vocab_size}, "
              f"{n_params[0] / 1e9:.3f} B params; M_L {large.cfg.n_layers} "
              f"layers d_model {large.cfg.d_model}, {n_params[1] / 1e9:.3f} "
              f"B params; {cfg.param_dtype} weights, {cfg.compute_dtype} "
              f"activations/cache; init {time.perf_counter() - t0:.1f} s")

        # one full-width decode step: kernel path against plain path, with
        # fp32 activations (isolates the kernels) and with the main config
        for label, step_cfg, tol in (
                ("fp32 activations", cfg.replace(compute_dtype="float32"),
                 STEP_LOGIT_ATOL),
                ("bf16 activations", cfg, STEP_LOGIT_GUARD)):
            err, agree, scale = decode_step_check(torch, tfm, small.params,
                                                  step_cfg, rng)
            print(f"[main] one decode step, kernel vs plain path, {label}, "
                  f"bf16 cache: max|dlogit| {err:.4g} (atol {tol}; logit std "
                  f"{scale:.3g}), argmax agreement {agree:.3f}")
            if not err <= tol:
                raise AssertionError(f"full-width decode step ({label}) "
                                     f"logits differ by {err} > {tol}")
        wall_ms, busy_ms, top = profile_decode(torch, tfm, small.params, cfg,
                                               rng)
        busy = ("not measured (profiler saw no device time)" if busy_ms is None
                else f"device busy {busy_ms:.3f} ms ({busy_ms / wall_ms:.1%}, "
                     f"idle {1 - busy_ms / wall_ms:.1%})")
        print(f"[main] full-width decode step (8 rows, kernels on): host "
              f"wall {wall_ms:.3f} ms, {busy} on {smi}")
        for name, ms in top:
            print(f"[main]   {ms:.4f} ms/step  {name[:90]}")

        engine = ContinuousCascadeEngine(
            CascadeSpec.two_tier(small, large),
            EngineConfig(n_slots=N_SLOTS, backend="paged",
                         paged=PagedConfig(block_size=BLOCK,
                                           prefill_chunk=CHUNK,
                                           paged_kernel=True)))
        cal_len = sum(RAGGED) // 2
        cal = make_lm_stream([SEED, 1], N_REQUESTS, cal_len, cfg.vocab_size)
        live = make_ragged_lm_stream([SEED, 2], N_REQUESTS, *RAGGED,
                                     cfg.vocab_size)
        torch.cuda.reset_peak_memory_stats()
        pa.paged_flash_decode_gqa.launches = 0
        pa.paged_write_token.launches = 0
        t0 = time.perf_counter()
        tau = engine.calibrate(cal, cal_len, MAX_NEW, DEFERRAL)
        torch.cuda.synchronize()
        t_cal = time.perf_counter() - t0
        res = engine.run(make_requests(live, MAX_NEW), MAX_NEW)
        torch.cuda.synchronize()
        launches = {"paged_flash_decode_gqa": pa.paged_flash_decode_gqa.launches,
                    "paged_write_token": pa.paged_write_token.launches}
        st = res.stats
        print(f"[main] calibrated tau {tau:.4f} for deferral {DEFERRAL} in "
              f"{t_cal:.2f} s; served {N_REQUESTS} requests (prompts "
              f"{RAGGED[0]}-{RAGGED[1]} tokens, max_new {MAX_NEW}) on "
              f"{N_SLOTS} slots in {st['makespan_s']:.3f} s: "
              f"{st['throughput_tok_s']:.1f} tok/s, M_S "
              f"{st['small_tok_s']:.1f} tok/s, deferral_ratio "
              f"{res.deferral_ratio:.3f}, early exits "
              f"{int(res.early_exited.sum())}, {res.steps} decode steps, "
              f"{st['prefill_dispatches']} prefill dispatches, peak blocks "
              f"{st['peak_blocks']}/{st['n_blocks']}, peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {smi}")
        print(f"[main] phases (host wall s): " + ", ".join(
            f"{k[6:-2]} {v:.3f}" for k, v in st.items()
            if k.startswith("phase_")))
        if not all(r.state == DONE for r in res.requests):
            raise AssertionError("not every request finished")
        if res.tokens.shape != (N_REQUESTS, MAX_NEW) or not np.isfinite(
                res.confidence).all():
            raise AssertionError("malformed serving result")
        want = {"paged_write_token": 2 * cfg.n_layers * res.steps,
                "paged_flash_decode_gqa": cfg.n_layers * res.steps}
        print(f"[main] kernel launches {launches}, expected {want} "
              f"(2*{cfg.n_layers} and {cfg.n_layers} per decode step)")
        if launches != want or res.steps == 0:
            raise AssertionError(f"launch counts {launches} != {want}")
        del engine, small, large
        torch.cuda.empty_cache()

        # -- 5. reduced fp32 fixture: kernel path == plain path -------------
        small, large = serve.build_ladder(ARCH, SEED, 2, device=DEV)
        prompts = make_ragged_lm_stream([SEED, 3], 8, 4, 24,
                                        small.cfg.vocab_size)
        runs = {}
        for kernel in (True, False):
            eng = ContinuousCascadeEngine(
                CascadeSpec.two_tier(small, large, tau=-1e9),
                EngineConfig(n_slots=3, early_exit=False, backend="paged",
                             paged=PagedConfig(block_size=4, prefill_chunk=4,
                                               paged_kernel=kernel)))
            runs[kernel] = eng.run(make_requests(prompts, 6), 6)
        for a, b in zip(runs[True].requests, runs[False].requests):
            if not np.array_equal(a.tokens, b.tokens):
                raise AssertionError(f"reduced fixture rid {a.rid}: kernel "
                                     f"tokens {a.tokens} != plain {b.tokens}")
        conf_err = float(np.abs(runs[True].confidence
                                - runs[False].confidence).max())
        print(f"[reduced] fp32 fixture, kernel vs plain path: identical "
              f"greedy tokens for {len(prompts)} requests, max|dconf| "
              f"{conf_err:.3g}")
        res = serve.main([])
        if not all(r.state == DONE for r in res.requests):
            raise AssertionError("serve.main() left requests unfinished")

    for name, rec in records.items():
        rec["launches"] = launches[name]
    print(json.dumps({"kernels": [records["paged_flash_decode_gqa"],
                                  records["paged_write_token"]]}))
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def prepare_decode(torch, tfm, params, cfg, rng) -> dict:
    """Prefill 8 ragged full-width prompts into a bf16 paged cache: the
    state of one decode step of the main path."""
    lens = rng.integers(RAGGED[0], RAGGED[1] + 1, size=N_SLOTS)
    per_row = math.ceil((RAGGED[1] + MAX_NEW) / BLOCK)
    tables = torch.zeros((N_SLOTS, per_row + 1), dtype=torch.int32)
    perm = torch.from_numpy(rng.permutation(N_SLOTS * per_row).astype("int32")
                            + 1)
    for b in range(N_SLOTS):
        n = math.ceil((int(lens[b]) + 1) / BLOCK)
        tables[b, :n] = perm[b * per_row:b * per_row + n]
    tables = tables.to(DEV)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, size=(N_SLOTS, int(lens.max())))).to(DEV)
    cache = tfm.init_cache(cfg, N_SLOTS * per_row + 1, BLOCK,
                           dtype=torch.bfloat16, device=DEV)
    logits, cache = tfm.prefill(params, cfg, toks, cache, pages=tables,
                                last_index=torch.from_numpy(lens - 1).to(DEV))
    return dict(tables=tables, cache=cache,
                tok=torch.argmax(logits[:, 0], -1).to(torch.int32),
                pos=torch.from_numpy(lens.astype("int32")).to(DEV))


def decode_step_check(torch, tfm, params, cfg, rng):
    """One decode step through the kernel path and through the plain path,
    on copies of one prepared cache. Returns (max |logit difference|,
    argmax agreement, logit std)."""
    d = prepare_decode(torch, tfm, params, cfg, rng)
    out = {}
    for kernel in (True, False):
        c = {"dense": {k: v.clone() for k, v in d["cache"]["dense"].items()}}
        out[kernel], _ = tfm.decode_step(params, cfg, d["tok"], d["pos"], c,
                                         pages=d["tables"],
                                         paged_kernel=kernel)
    torch.cuda.synchronize()
    if not torch.isfinite(out[True]).all() or out[True].shape != (
            N_SLOTS, cfg.vocab_size):
        raise AssertionError("full-width decode step: bad logits")
    err = float((out[True] - out[False]).abs().max())
    agree = float((out[True].argmax(-1) == out[False].argmax(-1)).float().mean())
    return err, agree, float(out[False].std())


def profile_decode(torch, tfm, params, cfg, rng, steps: int = 5):
    """Main-path decode steps (kernels on) timed on the host clock, then
    again under torch.profiler for the device-busy time. Returns (wall ms
    per step, device-busy ms per step or None, [(kernel, ms per step)])."""
    from torch.profiler import ProfilerActivity, profile
    d = prepare_decode(torch, tfm, params, cfg, rng)

    def run():
        for _ in range(steps):
            tfm.decode_step(params, cfg, d["tok"], d["pos"], d["cache"],
                            pages=d["tables"], paged_kernel=True)
        torch.cuda.synchronize()
    run()                                             # warm-up
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / steps)
    busy = sum(by_name.values()) or None
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return wall_ms, busy, top


if __name__ == "__main__":
    sys.exit(main())
