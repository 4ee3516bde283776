"""The two-tier ladders of the port on the CPU: the full-width large tier
of every served arch from shapes alone (unchanged for the archs served
before, a valid MHA for the qwens), the reduced ladder of all ten archs
against JAX's `build_ladder`, and the M_L backends' constructors against
a call in JAX's positional order."""
import pytest

import jax

import repro.configs as jconfigs
from _decoder_cases import fields_equal, jshapes, named, shapes
from repro.configs import get_config
from repro.launch import serve as jserve
from repro.models import transformer as jtfm
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as ttfm


# the full-width large tier of each served arch: parameters, and the
# config JAX's build_ladder formula gives (4 layers, 2 x d_model and d_ff,
# 8 heads, the small tier's KV heads), which the rule leaves alone
PINNED_LARGE = {"internlm2-1.8b": 1_630_572_544,
                "deepseek-v2-236b": 25_931_581_440,
                "rwkv6-3b": 2_043_663_360,
                "zamba2-1.2b": 891_518_976}
# the qwens' large tier: the formula's 8 heads over 8 KV heads (MHA)
VALID_LARGE = {"qwen1.5-4b": 2_489_115_648, "qwen1.5-32b": 10_014_005_248}


def _formula(cfg):
    return cfg.replace(name=cfg.name + "-large", n_layers=4,
                       d_model=cfg.d_model * 2, n_heads=8,
                       d_ff=cfg.d_ff * 2)


@pytest.mark.parametrize("arch", list(PINNED_LARGE) + list(VALID_LARGE))
def test_full_width_large_tier_fromshapes(arch):
    """The full-width large tier, from shapes alone: unchanged for the
    archs served before (the JAX formula's config, its tree equal to JAX's
    abstract init of that config, its parameter count pinned); for the
    qwens, whose 20 and 40 KV heads exceed the tier's 8 query heads, 8 KV
    heads, a valid MHA whose tree equals JAX's abstract init of it."""
    small = t_get_config(arch)
    cfg = tserve.large_tier_config(small)
    if arch in PINNED_LARGE:
        assert cfg == _formula(small)
    else:
        assert cfg == _formula(small).replace(n_kv_heads=8)
    if cfg.family in ("dense", "moe") and cfg.mla is None:
        assert cfg.n_heads % cfg.n_kv_heads == 0
    jcfg = get_config(arch).replace(
        n_layers=cfg.n_layers, d_model=cfg.d_model, n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads, d_ff=cfg.d_ff)
    tp = ttfm.init_params(cfg, 0, "meta")
    assert shapes(tp) == jshapes(jtfm.init_params(
        jcfg, jax.random.PRNGKey(0), abstract=True))
    n = sum(t.numel() for t in named(tp).values())
    assert n == {**PINNED_LARGE, **VALID_LARGE}[arch]


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_reduced_ladder_equals_jax_build_ladder(arch):
    """Both tiers of the reduced ladder, for all ten archs, equal the
    configs of JAX's `build_ladder(arch, seed, 2)` field by field; the
    served archs' runners through the port's `build_ladder` too."""
    jcfgs = [r.cfg for r in jserve.build_ladder(arch, 0, 2)]
    small = t_reduced(t_get_config(arch))
    for t, j in zip((small, tserve.large_tier_config(small)), jcfgs):
        fields_equal(t, j)
    if small.family not in ttfm._STEP_FAMILIES:
        runners = tserve.build_ladder(arch, 0, 2, device="cpu")
        for r, j in zip(runners, jcfgs):
            fields_equal(r.cfg, j)


# ---------------------------------------------------------------------------
# The M_L backends' constructors against JAX's positional order
# ---------------------------------------------------------------------------

class _Runner:
    """Stands in for a runner: the constructors must fail before they
    touch one."""
    def __getattr__(self, name):
        raise AssertionError(f"the constructor used the runner ({name})")


@pytest.mark.parametrize("kind", ["thread", "stub", "server"])
def test_backends_refuse_a_call_in_jax_positional_order(kind):
    """JAX's signatures put `poll_interval` after `max_wait` (after `port`
    for `MLServer`), where the port has none: a call in JAX's positional
    order raises TypeError, as `poll_interval=` by name does, instead of
    binding the float to `registry` or `latency`."""
    from repro_torch.serving.large_backend import (RemoteStubBackend,
                                                   ThreadedBackend)
    from repro_torch.serving.remote import MLServer
    cls, jax_order = {
        # (runner, max_new, large_batch, max_wait, poll_interval, registry)
        "thread": (ThreadedBackend, (_Runner(), 4, None, None, 0.002, None)),
        # (..., max_wait, latency, poll_interval, registry)
        "stub": (RemoteStubBackend,
                 (_Runner(), 4, None, None, 0.0, 0.002, None)),
        # (..., max_wait, host, port, poll_interval, latency, registry)
        "server": (MLServer, (_Runner(), 4, None, None, "127.0.0.1", 0,
                              0.002, 0.0, None)),
    }[kind]
    with pytest.raises(TypeError, match="positional"):
        cls(*jax_order)
    with pytest.raises(TypeError, match="poll_interval"):
        cls(_Runner(), 4, poll_interval=0.002)
