"""Port's eq.-8 deferral signal on the CPU against the JAX package: the
`deferral_entropy` kernel's plain version and `ops.deferral_signal`
against the Pallas kernel (interpret mode) and `deferral_entropy_ref`,
on vocabularies with a tail and rows with ties; the array-level signals
of `core.deferral` against JAX `SIGNALS`; and `fused_confidence`,
`make_prefill` and `make_serve_step` against `repro.launch.steps` on the
reduced internlm2-1.8b and DeepSeek-V2 (fp32, JAX weights carried over by
`convert.py`). Inputs come from numpy seeds."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.configs import get_config, reduced
from repro.core import deferral as jdef
from repro.kernels import ops as jops
from repro.kernels.ref import deferral_entropy_ref
from repro.launch import steps as jsteps
from repro.models import transformer as jtfm
from repro.serving import engine as jeng
from repro.sharding import ParallelContext
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.convert import params_from_jax
from repro_torch.core import deferral as tdef
from repro_torch.kernels import deferral_entropy as tde
from repro_torch.kernels import ops as tops
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as ttfm
from repro_torch.serving import engine as teng

torch.set_num_threads(1)
CTX = ParallelContext()
ATOL = 1e-5        # fp32 on both sides, sums in other orders


def _logits(seed, T, V, scale=4.0):
    """Normal logits with ties: row 0 all equal, row 1 an exact top tie
    at two far-apart columns, row 2 a top tie at neighbouring columns."""
    x = (np.random.default_rng(seed).standard_normal((T, V)) * scale
         ).astype(np.float32)
    x[0] = 0.5
    top = x[1].max() + 1.0
    x[1, 3], x[1, V - 2] = top, top
    top = x[2].max() + 1.0
    x[2, V // 2], x[2, V // 2 + 1] = top, top
    return x


@pytest.mark.parametrize("T,V,vb", [(12, 1000, 256), (9, 50, 64),
                                    (16, 513, 128)],
                         ids=["vocab-tail", "one-block", "tail-of-one"])
def test_plain_matches_jax_kernel_and_ref(T, V, vb):
    """neg_entropy and max_prob within 1e-5 of the Pallas kernel (interpret
    mode, vocabulary blocks of `vb` with a tail, rows padded to its token
    tile) and of the reference; argmax exact, ties to the lowest index."""
    x = _logits(T * V, T, V)
    jk = [np.asarray(a) for a in jops.deferral_signal(
        jnp.asarray(x), interpret=True, tb=8, vb=vb)]
    jr = [np.asarray(a) for a in deferral_entropy_ref(jnp.asarray(x))]
    tp = [a.numpy() for a in tde.deferral_entropy_plain(torch.from_numpy(x))]
    for ref in (jk, jr):
        np.testing.assert_allclose(tp[0], ref[0], atol=ATOL, rtol=0)
        np.testing.assert_allclose(tp[1], ref[1], atol=ATOL, rtol=0)
        np.testing.assert_array_equal(tp[2], ref[2])
    assert tp[2].dtype == np.int32
    assert tp[2][0] == 0 and tp[2][1] == 3 and tp[2][2] == V // 2
    np.testing.assert_allclose(tp[0][0], -np.log(V), rtol=1e-6)


def test_ops_signal_flattens_rows_and_wrapper_takes_plain_on_cpu():
    """ops.deferral_signal on [..., V] is the plain version row by row on
    CPU tensors, and launches nothing there."""
    x = _logits(5, 24, 300).reshape(2, 3, 4, 300)
    n = tde.deferral_entropy.launches
    got = tops.deferral_signal(torch.from_numpy(x))
    want = tde.deferral_entropy_plain(torch.from_numpy(x.reshape(24, 300)))
    assert tde.deferral_entropy.launches == n
    for g, w in zip(got, want):
        assert g.shape == (2, 3, 4)
        torch.testing.assert_close(g.reshape(-1), w, atol=0, rtol=0)
    ref = deferral_entropy_ref(jnp.asarray(x.reshape(24, 300)))
    np.testing.assert_array_equal(got[2].reshape(-1).numpy(),
                                  np.asarray(ref[2]))


def test_vocab_split_covers_the_vocabulary():
    for T, V in ((8, 92544), (8, 102400), (2048, 92544), (3, 50), (1, 7)):
        span, n = tde.vocab_split(T, V, 132)
        assert span % 8 == 0 and span * n >= V > span * (n - 1)
    assert tde.vocab_split(8, 92544, 132) == (2016, 46)
    assert tde.vocab_split(2048, 92544, 132)[1] == 1


@pytest.mark.parametrize("name", sorted(jdef.SIGNALS))
def test_signals_match_jax(name):
    """Every array-level signal on logits [3, 10, 7], and the sequence
    signal with a mask: 1e-5 of JAX's."""
    x = np.random.default_rng(1).standard_normal((3, 10, 7)).astype(np.float32)
    mask = np.zeros((3, 10), np.float32)
    mask[:, :4] = 1.0
    mask[1, 4:6] = 1.0
    jfn, tfn = jdef.SIGNALS[name], tdef.SIGNALS[name]
    args = [(x,)] + ([(x, mask)] if name == "seq_neg_entropy" else [])
    for a in args:
        ref = np.asarray(jfn(*[jnp.asarray(t) for t in a]))
        got = tfn(*[torch.from_numpy(t) for t in a]).numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
def test_engine_signal_matches_jax_engine(kernel):
    """The serving engine's (token, confidence) per decode row, on either
    path, against the JAX engine's `_neg_entropy` and `jnp.argmax`:
    tokens exact, confidence within 1e-5; both paths equal bit for bit on
    CPU tensors (the kernel path's wrapper runs the plain version)."""
    x = _logits(2, 6, 77)
    tok, nent = teng._signal(torch.from_numpy(x), kernel)
    np.testing.assert_array_equal(tok.numpy(),
                                  np.asarray(jnp.argmax(jnp.asarray(x), -1)))
    np.testing.assert_allclose(nent.numpy(),
                               np.asarray(jeng._neg_entropy(jnp.asarray(x))),
                               atol=ATOL, rtol=0)
    other = teng._signal(torch.from_numpy(x), not kernel)
    torch.testing.assert_close(tok, other[0], atol=0, rtol=0)
    torch.testing.assert_close(nent, other[1], atol=0, rtol=0)


# ---------------------------------------------------------------------------
# launch.steps: fused_confidence, make_prefill, make_serve_step
# ---------------------------------------------------------------------------

def _cfgs(arch):
    return reduced(get_config(arch)), t_reduced(t_get_config(arch))


@pytest.fixture(scope="module", params=["internlm2-1.8b", "deepseek-v2-236b"])
def model(request):
    cfg, tcfg = _cfgs(request.param)
    jparams = jtfm.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, tcfg, jparams, params_from_jax(jax.device_get(jparams), "cpu")


@pytest.mark.parametrize("n_chunks", [8, 3])
def test_fused_confidence_matches_jax(n_chunks):
    """Chunked two-pass signal of hidden states against JAX's, with a tie
    in the argmax across chunks; 3 chunks halve to 2 on V = 512."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((10, 32)).astype(np.float32)
    table = (rng.standard_normal((512, 32)) / np.sqrt(32)).astype(np.float32)
    table[400] = table[int(np.argmax(x[0] @ table.T))]   # row 0: a tie
    ref = [np.asarray(a) for a in jsteps.fused_confidence(
        jnp.asarray(x), jnp.asarray(table), n_chunks=n_chunks)]
    got = [a.numpy() for a in tsteps.fused_confidence(
        torch.from_numpy(x), torch.from_numpy(table), n_chunks=n_chunks)]
    np.testing.assert_allclose(got[0], ref[0], atol=ATOL, rtol=0)
    np.testing.assert_allclose(got[1], ref[1], atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got[2], ref[2])
    plain = tde.deferral_entropy_plain(torch.from_numpy(x @ table.T))
    np.testing.assert_array_equal(got[2], plain[2].numpy())


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
def test_prefill_and_serve_steps_match_jax(model, kernel):
    """make_prefill then three make_serve_step steps, against JAX's builders
    on the same weights and prompts: greedy tokens and defer masks exact,
    confidences within 1e-5. tau lies midway between two of JAX's prefill
    confidences, inside the range the steps' confidences take. `kernel`
    forces the kernel path, whose wrappers run their plain versions on CPU
    tensors."""
    cfg, tcfg, jparams, tparams = model
    B, P, steps = 4, 7, 3
    prompts = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, P)).astype(np.int32)
    jcache = jtfm.init_cache(cfg, B, P + steps)
    jtok, jnent, jcache = jsteps.make_prefill(cfg, CTX)(
        jparams, jcache, {"tokens": jnp.asarray(prompts)})
    tcache = ttfm.init_cache(tcfg, B, P + steps, device="cpu")
    ttok, tnent, tcache = tsteps.make_prefill(tcfg, paged_kernel=kernel)(
        tparams, tcache, {"tokens": torch.from_numpy(prompts.astype(np.int64))})
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(tnent.numpy(), np.asarray(jnent), atol=ATOL,
                               rtol=0)
    conf0 = np.sort(np.asarray(jnent))
    tau = float(0.5 * (conf0[1] + conf0[2]))
    jstep = jsteps.make_serve_step(cfg, CTX, tau=tau)
    tstep = tsteps.make_serve_step(tcfg, tau=tau, paged_kernel=kernel)
    jt, tt = jtok.astype(jnp.int32), ttok
    for i in range(steps):
        jt, jc, jd, jcache = jstep(jparams, jcache, jt, P + i)
        tt, tc, td, tcache = tstep(tparams, tcache, tt, P + i)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=ATOL,
                                   rtol=0)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert tt.dtype == torch.int32 and td.dtype == torch.bool


def test_serve_step_kernel_path_equals_plain_path(model):
    """On one decode state, the serve step's kernel path (unembed +
    deferral_signal) and plain path (fused_confidence) agree: tokens exact,
    confidences within 1e-5."""
    _, tcfg, _, tparams = model
    B, P = 3, 6
    prompts = torch.from_numpy(np.random.default_rng(6).integers(
        0, tcfg.vocab_size, (B, P)))
    out = {}
    for kernel in (False, True):
        cache = ttfm.init_cache(tcfg, B, P + 1, device="cpu")
        tok, _, cache = tsteps.make_prefill(tcfg, paged_kernel=kernel)(
            tparams, cache, {"tokens": prompts})
        out[kernel] = tsteps.make_serve_step(tcfg, paged_kernel=kernel)(
            tparams, cache, tok, P)
    torch.testing.assert_close(out[True][0], out[False][0], atol=0, rtol=0)
    torch.testing.assert_close(out[True][1], out[False][1], atol=ATOL, rtol=0)


def test_serve_builders_reject_encdec():
    """The builders run the encoder-decoder family (tests/
    test_torch_encdec.py), but refuse an encdec config that has no
    EncoderSpec to encode with, and a vlm one without its VisionSpec."""
    base = t_reduced(t_get_config("internlm2-1.8b"))
    for family, spec in (("encdec", "EncoderSpec"), ("vlm", "VisionSpec")):
        tcfg = base.replace(family=family)
        for build in (tsteps.make_prefill, tsteps.make_serve_step):
            with pytest.raises(ValueError, match=spec):
                build(tcfg)
    tsteps.make_prefill(t_reduced(t_get_config("whisper-small")))


def test_engine_switch_reaches_calibration_and_large_model(monkeypatch):
    """The continuous engine's `paged_kernel` reaches `ModelRunner.generate`
    in calibration and behind the M_L backend, over a REPRO_PAGED_KERNEL
    that says the opposite: on, every signal of the run (M_S steps and
    seeds, one per M_L generate step) goes through
    `kernel_ops.deferral_signal`; off, none does."""
    from repro_torch.data.synthetic import make_lm_stream
    from repro_torch.launch import serve as tserve
    from repro_torch.serving import (CascadeSpec, ContinuousCascadeEngine,
                                     EngineConfig, PagedConfig, make_requests)
    calls = []
    real = tops.deferral_signal

    def counted(logits):
        calls.append(logits.shape[0])
        return real(logits)
    monkeypatch.setattr(tops, "deferral_signal", counted)
    small, large = tserve.build_ladder("internlm2-1.8b", 0, 2, device="cpu")
    prompts = make_lm_stream(3, 4, 6, small.cfg.vocab_size)
    max_new = 3
    for kernel in (True, False):
        monkeypatch.setenv("REPRO_PAGED_KERNEL", "0" if kernel else "1")
        eng = ContinuousCascadeEngine(
            CascadeSpec.two_tier(small, large),
            EngineConfig(n_slots=2, early_exit=False, backend="paged",
                         paged=PagedConfig(block_size=4, prefill_chunk=4,
                                           paged_kernel=kernel)))
        calls.clear()
        eng.calibrate(prompts, prompts.shape[1], max_new, deferral_ratio=0.5)
        n_cal = len(calls)
        eng.tau = 1e9                       # every request goes to M_L
        calls.clear()
        res = eng.run(make_requests(prompts, max_new), max_new)
        assert res.deferred.all()
        if kernel:
            assert n_cal == max_new
            assert len(calls) == (res.steps
                                  + res.stats["prefill_seed_dispatches"]
                                  + max_new * res.stats["ml_batches"])
        else:
            assert n_cal == 0 and calls == []
