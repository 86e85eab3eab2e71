"""The port's LM serving path (``repro_torch.models``, ``repro_torch.serve``)
against the reference's, on zamba2-1.2b's and qwen2-vl-7b's smoke configs
and the ``zamba_hybrid``, ``swa_moe``, ``mla_moe`` and ``rwkv`` configs of
``tests/test_models.py``, all fp32.

The reference's weights cross over with ``convert.lm_params_from_jax``, so
both packages compute the same function; on the CPU the port's attention
and SSD scan run their kernels' plain versions.  Tolerances: prefill
logits and cache leaves at rtol/atol 2e-4 (fp32 in both, summed in other
orders: measured gaps are about 4e-5); decode logits at the reference's own
2e-3 (``tests/test_models.py``); greedy tokens exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import qwen2_vl_7b as ref_qwen2_vl  # noqa: E402
from repro.configs import zamba2_1p2b as ref_zamba  # noqa: E402
from repro.models.attention import causal_mask as ref_mask  # noqa: E402
from repro.models.model import build_model as ref_build  # noqa: E402
from repro.models.model import count_params_from_shapes  # noqa: E402
from repro.models.model import pad_caches as ref_pad  # noqa: E402
from repro.serve.engine import ServeEngine as RefEngine  # noqa: E402
from repro_torch.configs import zamba2_1p2b  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.models.attention import causal_mask  # noqa: E402
from repro_torch.models.model import build_model, pad_caches  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from test_models import CONFIGS  # noqa: E402
from torch_port_util import port_model_config  # noqa: E402

PREFILL_TOL = 2e-4
DECODE_TOL = 2e-3
B, S = 2, 16


#: the pair fixture's configs and the cache leaves each one's caches hold
PAIRS = {
    "zamba2_smoke": (ref_zamba.smoke, {"k", "v", "conv", "ssm"}),
    "zamba_hybrid": (lambda: CONFIGS["zamba_hybrid"],
                     {"k", "v", "conv", "ssm"}),
    "swa_moe": (lambda: CONFIGS["swa_moe"], {"k", "v"}),
    "mla_moe": (lambda: CONFIGS["mla_moe"], {"c_kv", "k_rope"}),
    "rwkv": (lambda: CONFIGS["rwkv"], {"S", "x_prev"}),
    "qwen2_vl_smoke": (ref_qwen2_vl.smoke, {"k", "v"}),
}

CACHE_LEAVES = {make().name: leaves for make, leaves in PAIRS.values()}


@pytest.fixture(scope="module", params=list(PAIRS))
def pair(request):
    ref_cfg = PAIRS[request.param][0]()
    cfg = port_model_config(ref_cfg)
    ref_model = ref_build(ref_cfg)
    ref_params = ref_model.init(jax.random.key(0))
    params = lm_params_from_jax(cfg, jax.tree.map(np.asarray, ref_params),
                                device="cpu")
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)
    return (ref_cfg, ref_model, ref_params), (cfg, build_model(cfg), params), \
        tokens


def by_path(tree, prefix=""):
    """``{path: numpy leaf}`` of a nested dict/list of arrays or tensors."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(by_path(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(by_path(v, f"{prefix}[{i}]"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.to(torch.float32).numpy()}
    return {prefix: np.asarray(tree, np.float32)}


def close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol, err_msg=what)


def test_prefill_logits_and_every_cache_leaf(pair):
    (rcfg, rmodel, rparams), (cfg, model, params), tokens = pair
    want_logits, want_caches = rmodel.prefill(rparams, jnp.asarray(tokens))
    got_logits, got_caches = model.prefill(params, torch.from_numpy(tokens))
    close(got_logits, want_logits, PREFILL_TOL, "logits")
    want, got = by_path(want_caches), by_path(got_caches)
    assert list(got) == list(want)
    kinds = {p.rsplit("/", 1)[-1] for p in want}
    assert kinds == CACHE_LEAVES[rcfg.name]
    for path in want:
        assert got[path].shape == want[path].shape, path
        close(got[path], want[path], PREFILL_TOL, path)


@pytest.mark.parametrize("steps", [1, 2])
def test_decode_steps_match_reference(pair, steps):
    (rcfg, rmodel, rparams), (cfg, model, params), tokens = pair
    S0 = S - steps
    _, rc = rmodel.prefill(rparams, jnp.asarray(tokens[:, :S0]))
    rc = ref_pad(rcfg, rc, S)
    _, pc = model.prefill(params, torch.from_numpy(tokens[:, :S0]))
    pc = pad_caches(cfg, pc, S)
    for t in range(S0, S):
        want, rc = rmodel.decode_step(rparams, jnp.asarray(tokens[:, t]),
                                      jnp.full((B,), t, jnp.int32), rc)
        got, pc = model.decode_step(params, torch.from_numpy(tokens[:, t]),
                                    torch.full((B,), t), pc)
        close(got, want, DECODE_TOL, f"step at position {t}")


def test_prefill_plus_decode_matches_own_forward(pair):
    _, (cfg, model, params), tokens = pair
    full, _ = model.forward(params, torch.from_numpy(tokens))
    _, caches = model.prefill(params, torch.from_numpy(tokens[:, :S - 2]))
    caches = pad_caches(cfg, caches, S)
    for t in (S - 2, S - 1):
        got, caches = model.decode_step(params,
                                        torch.from_numpy(tokens[:, t]),
                                        torch.full((B,), t), caches)
        close(got, full[:, t], DECODE_TOL, f"position {t}")


def test_greedy_generate_matches_reference():
    """serve_demo's sizes: 4 requests, 12-token prompts, 8 new tokens."""
    rcfg = ref_zamba.smoke()
    cfg = port_model_config(rcfg)
    rparams = ref_build(rcfg).init(jax.random.key(0))
    params = lm_params_from_jax(cfg, jax.tree.map(np.asarray, rparams),
                                device="cpu")
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab, (4, 12)).astype(np.int32)
    want = RefEngine(rcfg, rparams, capacity=21, batch_size=4).generate(
        prompts, 8)
    got = ServeEngine(cfg, params, capacity=21, batch_size=4,
                      device="cpu").generate(prompts, 8)
    assert got.tokens.shape == (4, 8)
    np.testing.assert_array_equal(got.tokens, want.tokens)


def test_temperature_sampling_is_seeded():
    cfg = zamba2_1p2b.smoke()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    engine = ServeEngine(cfg, params, capacity=12, batch_size=2,
                         device="cpu")
    prompts = np.arange(16, dtype=np.int32).reshape(2, 8)
    a = engine.generate(prompts, 4, temperature=0.8, seed=5)
    b = engine.generate(prompts, 4, temperature=0.8, seed=5)
    np.testing.assert_array_equal(a.tokens, b.tokens)
    assert a.tokens.min() >= 0 and a.tokens.max() < cfg.vocab


@pytest.mark.parametrize("L", [24, 7])
def test_ssm_full_from_a_state_matches_reference(L):
    """One Mamba2 layer's ``ssm_full`` from a given conv and SSM state (the
    scan's initial state) equals the reference's on zamba2's smoke config,
    and a prompt in two parts equals the whole prompt."""
    from repro.models.ssm import ssm_full as ref_ssm_full
    from repro_torch.models.ssm import ssm_dims, ssm_full
    rcfg = ref_zamba.smoke()
    cfg = port_model_config(rcfg)
    rparams = ref_build(rcfg).init(jax.random.key(0))
    params = lm_params_from_jax(cfg, jax.tree.map(np.asarray, rparams),
                                device="cpu")
    rp = {k: np.asarray(v[0]) for k, v in rparams["runs"][0]["ssm"].items()}
    p = {k: v[0] for k, v in params["runs"][0]["ssm"].items()}
    d_inner, H, N = ssm_dims(cfg)
    r = np.random.default_rng(L)
    x = r.normal(size=(B, L, cfg.d_model)).astype(np.float32)
    state = {"conv": r.normal(size=(B, cfg.ssm.conv_width - 1,
                                    d_inner + 2 * N)).astype(np.float32),
             "ssm": r.normal(size=(B, H, cfg.ssm.head_dim, N)).astype(
                 np.float32)}
    want, want_state = ref_ssm_full(
        rcfg, {k: jnp.asarray(v) for k, v in rp.items()}, jnp.asarray(x),
        {k: jnp.asarray(v) for k, v in state.items()})
    got, got_state = ssm_full(cfg, p, torch.from_numpy(x),
                              {k: torch.from_numpy(v)
                               for k, v in state.items()})
    close(got, want, PREFILL_TOL, "output")
    for k in ("conv", "ssm"):
        close(got_state[k], want_state[k], PREFILL_TOL, k)
    half = L // 2
    first, mid = ssm_full(cfg, p, torch.from_numpy(x[:, :half]),
                          {k: torch.from_numpy(v) for k, v in state.items()})
    second, end = ssm_full(cfg, p, torch.from_numpy(x[:, half:]), mid)
    close(torch.cat([first, second], 1), got, PREFILL_TOL, "two parts")
    for k in ("conv", "ssm"):
        close(end[k], got_state[k], PREFILL_TOL, f"two parts {k}")


def test_param_count_of_full_config_matches_reference():
    assert zamba2_1p2b.full().param_count() == \
        count_params_from_shapes(ref_zamba.full())


def test_engine_needs_cuda_unless_asked_for_cpu():
    cfg = zamba2_1p2b.smoke()
    params = build_model(cfg).init(torch.Generator().manual_seed(0),
                                   device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a card is present: the engine would run")
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeEngine(cfg, params, capacity=8, batch_size=1)
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "zamba2_1p2b", "--reduced"])
    out = serve.main(["--arch", "zamba2_1p2b", "--reduced", "--device",
                      "cpu", "--batch", "2", "--prompt-len", "6",
                      "--new-tokens", "3"])
    assert out.tokens.shape == (2, 3)


@pytest.mark.parametrize("window,offset", [(None, 0), (4, 0), (None, 3)])
def test_causal_mask_matches_reference(window, offset):
    np.testing.assert_array_equal(
        causal_mask(6, 9, window, offset).numpy(),
        np.asarray(ref_mask(6, 9, window, offset)))


def test_init_cache_matches_reference(pair):
    (rcfg, rmodel, _), (cfg, model, _), _ = pair
    want = by_path(rmodel.init_cache(3, 20))
    got = model.init_cache(3, 20, device="cpu")
    flat = by_path(got)
    assert list(flat) == list(want)
    for path in want:
        assert flat[path].shape == want[path].shape, path
        assert not flat[path].any(), path
