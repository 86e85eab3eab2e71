"""The port's MoE, MLA, RWKV-6, M-RoPE and encoder-decoder serving paths
against the reference's, on the CPU.

The reference's weights cross over with ``convert.lm_params_from_jax``, so
both packages compute the same function; on the CPU the port's attention
runs K2's plain version.  Tolerances are ``test_torch_models.py``'s:
prefill logits, cache leaves, layer outputs and the MoE aux loss at
rtol/atol 2e-4 (fp32 in both, summed in other orders); decode logits at
the reference's own 2e-3 (``tests/test_models.py``); greedy tokens,
routed experts and parameter counts exactly.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import deepseek_v3_671b as ref_deepseek  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import mixtral_8x7b as ref_mixtral  # noqa: E402
from repro.configs import qwen2_vl_7b as ref_qwen2_vl  # noqa: E402
from repro.configs import rwkv6_3b as ref_rwkv  # noqa: E402
from repro.configs import whisper_large_v3 as ref_whisper  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import rwkv as ref_rwkv_mod  # noqa: E402
from repro.models.config import EncoderConfig, MoEConfig  # noqa: E402
from repro.models.config import ModelConfig as RefModelConfig  # noqa: E402
from repro.models.model import _pad_attn_cache as ref_pad_attn  # noqa: E402
from repro.models.model import build_model as ref_build  # noqa: E402
from repro.models.model import count_active_params as ref_active  # noqa: E402
from repro.models.model import (  # noqa: E402
    count_params_from_shapes as ref_count,
)
from repro.serve.engine import ServeEngine as RefEngine  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.models import layers, moe, rwkv  # noqa: E402
from repro_torch.models.model import (  # noqa: E402
    COMPUTE_LEAVES,
    _pad_attn_cache,
    build_model,
    cast_for_compute,
    count_active_params,
    count_params_from_shapes,
)
from repro_torch.serve.engine import ServeEngine  # noqa: E402
from test_models import CONFIGS, tiny  # noqa: E402
from test_torch_models import by_path, close  # noqa: E402
from torch_port_util import port_model_config  # noqa: E402

PREFILL_TOL = 2e-4
DECODE_TOL = 2e-3


def carried(ref_cfg, key=0):
    """(reference params, the port's config, the same params as tensors on
    the CPU).  The reference's calls are jitted in this file: one compile
    a function instead of one a primitive keeps the file quick."""
    cfg = port_model_config(ref_cfg)
    rparams = jax.jit(ref_build(ref_cfg).init)(jax.random.key(key))
    return rparams, cfg, lm_params_from_jax(
        cfg, jax.tree.map(np.asarray, rparams), device="cpu")


def rng_array(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


# ----------------------------------------------------------------------
# whisper: the encoder-decoder
# ----------------------------------------------------------------------

#: TestEncDec's config in tests/test_models.py
WHISPER = RefModelConfig(
    name="wh", family="audio", n_layers=3, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=128, remat_policy="none",
    dtype=jnp.float32, param_dtype=jnp.float32,
    encoder=EncoderConfig(n_layers=2, n_frames=24, d_model=64, n_heads=4,
                          d_ff=128))


@pytest.fixture(scope="module")
def whisper():
    rparams, cfg, params = carried(WHISPER)
    frames = rng_array(2, (2, 24, 64))
    tokens = np.random.default_rng(1).integers(0, 128, (2, 8)).astype(
        np.int32)
    return rparams, cfg, params, frames, tokens


def test_whisper_prefill_logits_caches_and_cross_kv(whisper):
    rparams, cfg, params, frames, tokens = whisper
    want_logits, want_state = jax.jit(ref_build(WHISPER).prefill)(
        rparams, jnp.asarray(frames), jnp.asarray(tokens))
    got_logits, got_state = build_model(cfg).prefill(
        params, torch.from_numpy(frames), torch.from_numpy(tokens))
    close(got_logits, want_logits, PREFILL_TOL, "logits")
    want, got = by_path(want_state), by_path(got_state)
    assert list(got) == list(want)
    assert {p.rsplit("/", 1)[-1] for p in want} == {"k", "v"}
    assert len(want) == 4          # self-attention k/v, cross k/v
    for path in want:
        assert got[path].shape == want[path].shape, path
        close(got[path], want[path], PREFILL_TOL, path)


@pytest.mark.parametrize("steps", [1, 3])
def test_whisper_decode_steps_match_reference(whisper, steps):
    rparams, cfg, params, frames, tokens = whisper
    B, S = tokens.shape
    S0 = S - steps
    rmodel, model = ref_build(WHISPER), build_model(cfg)
    _, (rc, rkv) = jax.jit(rmodel.prefill)(rparams, jnp.asarray(frames),
                                  jnp.asarray(tokens[:, :S0]))
    rstate = (ref_pad_attn(WHISPER, rc, S), rkv)
    _, (pc, pkv) = model.prefill(params, torch.from_numpy(frames),
                                 torch.from_numpy(tokens[:, :S0]))
    state = (_pad_attn_cache(cfg, pc, S), pkv)
    step = jax.jit(rmodel.decode_step)
    for t in range(S0, S):
        want, rstate = step(rparams, jnp.asarray(tokens[:, t]),
                            jnp.full((B,), t, jnp.int32), rstate)
        got, state = model.decode_step(params, torch.from_numpy(tokens[:, t]),
                                       torch.full((B,), t), state)
        close(got, want, DECODE_TOL, f"step at position {t}")
    full, _ = model.forward(params, torch.from_numpy(frames),
                            torch.from_numpy(tokens))
    close(got, full[:, -1], DECODE_TOL, "decode vs own forward")


def test_whisper_positions_wrap_past_the_table(whisper):
    """A decode step past the 8192-row position table takes its row modulo
    the table (``encdec.py:209-210`` in the reference)."""
    rparams, cfg, params, frames, tokens = whisper
    B, T = tokens.shape[0], 8200
    rmodel, model = ref_build(WHISPER), build_model(cfg)
    rstate = rmodel.init_cache(B, T)
    state = model.init_cache(B, T, device="cpu")
    assert [t.shape for t in by_path(state).values()] == \
        [t.shape for t in by_path(rstate).values()]
    pos = np.array([8192 + 1, 8192 + 3], np.int32)
    want, _ = jax.jit(rmodel.decode_step)(
        rparams, jnp.asarray(tokens[:, 0]), jnp.asarray(pos), rstate)
    got, _ = model.decode_step(params, torch.from_numpy(tokens[:, 0]),
                               torch.from_numpy(pos), state)
    close(got, want, DECODE_TOL, "decode past the table")


# ----------------------------------------------------------------------
# MoE routing and dispatch
# ----------------------------------------------------------------------

#: more than 64 experts: the sigmoid router of deepseek-v3
MANY_EXPERTS = MoEConfig(n_experts=72, top_k=8, d_ff_expert=8,
                         capacity_factor=1.25)


@pytest.mark.parametrize("m", [MANY_EXPERTS, MoEConfig(
    n_experts=4, top_k=2, d_ff_expert=8)], ids=["sigmoid72", "softmax4"])
def test_route_matches_reference(m):
    logits = rng_array(3, (40, m.n_experts), 2.0)
    w, e, aux = ref_moe._route(m, jnp.asarray(logits))
    gw, ge, gaux = moe._route(m, torch.from_numpy(logits))
    np.testing.assert_array_equal(ge.numpy(), np.asarray(e))
    close(gw, w, PREFILL_TOL, "weights")
    close(gaux, aux, PREFILL_TOL, "aux loss")
    assert gw.dtype == torch.float32


def _moe_pair(moe_cfg, seed=0):
    ref_cfg = tiny("moe", family="moe", moe=moe_cfg)
    cfg = port_model_config(ref_cfg)
    from repro.models.params import KeyGen
    rp = ref_moe.init_moe(ref_cfg, KeyGen(jax.random.key(seed)))
    p = {k: (torch.tensor(np.asarray(v)) if not isinstance(v, dict)
             else {kk: torch.tensor(np.asarray(vv)) for kk, vv in v.items()})
         for k, v in rp.items()}
    return ref_cfg, rp, cfg, p


@pytest.mark.parametrize("moe_cfg", [
    MoEConfig(n_experts=4, top_k=2, d_ff_expert=16, capacity_factor=0.5),
    MoEConfig(n_experts=4, top_k=2, d_ff_expert=16, n_groups=2),
    MoEConfig(n_experts=4, top_k=2, d_ff_expert=16, n_groups=3),
    MoEConfig(n_experts=4, top_k=2, d_ff_expert=16, capacity_factor=0.5,
              n_groups=-1),
    dataclasses.replace(MANY_EXPERTS, n_shared_experts=1),
], ids=["drops", "groups2", "groups3_fallback", "shard_local_fallback",
        "sigmoid72_shared"])
def test_moe_apply_matches_reference(moe_cfg):
    """Capacity drops (factor 0.5), two groups, a group count that does not
    divide the tokens (G falls back to 1), the shard-local mode's
    one-group fallback, and 72 experts with a shared one."""
    ref_cfg, rp, cfg, p = _moe_pair(moe_cfg)
    x = rng_array(4, (2, 10, 64))
    want, waux = jax.jit(lambda p, x: ref_moe.moe_apply(
        ref_cfg, p, x, jnp.float32))(rp, jnp.asarray(x))
    got, gaux = moe.moe_apply(cfg, p, torch.from_numpy(x), torch.float32)
    close(got, want, PREFILL_TOL, "output")
    close(gaux, waux, PREFILL_TOL, "aux loss")
    if moe_cfg.capacity_factor == 0.5:      # some slots really are dropped
        _, e, _ = moe._route(moe_cfg, torch.from_numpy(x).reshape(20, 64)
                             @ p["router"])
        assert int(torch.bincount(e.reshape(-1)).max()) > moe.capacity(
            moe_cfg, 20)


def test_capacity_matches_reference_arithmetic():
    for m, T in ((ref_mixtral.full().moe, 4 * 6144),
                 (ref_deepseek.full().moe, 2 * 1024),
                 (ref_deepseek.full().moe, 2), (MANY_EXPERTS, 7)):
        want = max(int(m.capacity_factor * T * m.top_k / m.n_experts), 1)
        assert moe.capacity(m, T) == -(-want // 8) * 8
    assert moe.capacity(ref_mixtral.full().moe, 4 * 6144) == 7680


def test_sigmoid_router_model_matches_reference():
    """A whole model over the sigmoid router: prefill logits, every cache
    leaf, the forward's aux loss, and a decode step."""
    ref_cfg = tiny("deepseek72", family="moe", n_kv_heads=4, n_layers=2,
                   moe=dataclasses.replace(MANY_EXPERTS, n_shared_experts=1,
                                           first_k_dense=1),
                   mla=CONFIGS["mla_moe"].mla)
    rparams, cfg, params = carried(ref_cfg)
    rmodel, model = ref_build(ref_cfg), build_model(cfg)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (2, 9)).astype(
        np.int32)
    want, rc = jax.jit(rmodel.prefill)(rparams, jnp.asarray(tokens[:, :8]))
    got, pc = model.prefill(params, torch.from_numpy(tokens[:, :8]))
    close(got, want, PREFILL_TOL, "logits")
    for path, leaf in by_path(rc).items():
        close(by_path(pc)[path], leaf, PREFILL_TOL, path)
    _, waux = jax.jit(rmodel.forward_train)(rparams, jnp.asarray(tokens))
    _, gaux = model.forward(params, torch.from_numpy(tokens))
    close(gaux, waux, PREFILL_TOL, "aux loss")
    from repro.models.model import pad_caches as ref_pad
    from repro_torch.models.model import pad_caches
    want, _ = jax.jit(rmodel.decode_step)(
        rparams, jnp.asarray(tokens[:, 8]), jnp.full((2,), 8, jnp.int32),
        ref_pad(ref_cfg, rc, 9))
    got, _ = model.decode_step(params, torch.from_numpy(tokens[:, 8]),
                               torch.full((2,), 8), pad_caches(cfg, pc, 9))
    close(got, want, DECODE_TOL, "decode")


# ----------------------------------------------------------------------
# RWKV-6
# ----------------------------------------------------------------------

@pytest.mark.parametrize("L", [11, 1])
def test_rwkv_time_mix_from_a_state(L):
    """``rwkv_time_full`` from a given (S, x_prev) equals the reference's;
    a prompt in two parts, the second from the first's state, equals the
    whole prompt; the channel mix likewise."""
    ref_cfg = CONFIGS["rwkv"]
    rparams, cfg, params = carried(ref_cfg)
    rp = jax.tree.map(lambda a: a[0], rparams["runs"][0])
    p = {k: {kk: vv[0] for kk, vv in v.items()}
         for k, v in params["runs"][0].items()}
    H, N = rwkv.rwkv_dims(cfg)
    x = rng_array(6, (2, L, cfg.d_model))
    state = {"S": rng_array(7, (2, H, N, N), 0.3),
             "x_prev": rng_array(8, (2, cfg.d_model))}
    tstate = {k: torch.from_numpy(v) for k, v in state.items()}
    want, wstate = jax.jit(lambda p, x, st: ref_rwkv_mod.rwkv_time_full(
        ref_cfg, p, x, st))(rp["time"], jnp.asarray(x),
                            {k: jnp.asarray(v) for k, v in state.items()})
    got, gstate = rwkv.rwkv_time_full(cfg, p["time"], torch.from_numpy(x),
                                      tstate)
    close(got, want, PREFILL_TOL, "time mix")
    for k in ("S", "x_prev"):
        close(gstate[k], wstate[k], PREFILL_TOL, k)
    assert gstate["S"].dtype == torch.float32
    want_c, wc = ref_rwkv_mod.rwkv_channel_full(
        ref_cfg, rp["channel"], jnp.asarray(x),
        {"x_prev": jnp.asarray(state["x_prev"])})
    got_c, gc = rwkv.rwkv_channel_full(
        cfg, p["channel"], torch.from_numpy(x),
        {"x_prev": tstate["x_prev"]})
    close(got_c, want_c, PREFILL_TOL, "channel mix")
    close(gc["x_prev"], wc["x_prev"], PREFILL_TOL, "channel x_prev")
    if L > 1:
        half = L // 2
        first, mid = rwkv.rwkv_time_full(cfg, p["time"],
                                         torch.from_numpy(x[:, :half]),
                                         tstate)
        second, end = rwkv.rwkv_time_full(cfg, p["time"],
                                          torch.from_numpy(x[:, half:]), mid)
        close(torch.cat([first, second], 1), got, PREFILL_TOL, "two parts")
        close(end["S"], gstate["S"], PREFILL_TOL, "two parts S")


def test_rwkv_long_prompt_crosses_loop_blocks():
    """A prompt longer than the loop's block of outer products."""
    ref_cfg = CONFIGS["rwkv"]
    rparams, cfg, params = carried(ref_cfg)
    rp = jax.tree.map(lambda a: a[0], rparams["runs"][0]["time"])
    p = {k: v[0] for k, v in params["runs"][0]["time"].items()}
    x = rng_array(9, (1, rwkv._BLOCK + 5, cfg.d_model))
    want, ws = jax.jit(lambda p, x: ref_rwkv_mod.rwkv_time_full(
        ref_cfg, p, x))(rp, jnp.asarray(x))
    got, gs = rwkv.rwkv_time_full(cfg, p, torch.from_numpy(x))
    close(got, want, PREFILL_TOL, "output")
    close(gs["S"], ws["S"], PREFILL_TOL, "S")


def test_rwkv_group_norm_matches_reference():
    y = rng_array(10, (2, 3, 64), 3.0)
    scale, bias = rng_array(11, (64,)), rng_array(12, (64,))
    want = ref_rwkv_mod._group_norm(jnp.asarray(y), jnp.asarray(scale),
                                    jnp.asarray(bias), 4)
    got = rwkv._group_norm(torch.from_numpy(y), torch.from_numpy(scale),
                           torch.from_numpy(bias), 4)
    close(got, want, PREFILL_TOL, "group norm")


# ----------------------------------------------------------------------
# layer primitives
# ----------------------------------------------------------------------

@pytest.mark.parametrize("d,sections", [(16, (1, 1, 2)), (128, (1, 1, 2)),
                                        (10, (1, 1, 2)), (24, (2, 3, 3))])
def test_apply_mrope_matches_reference(d, sections):
    x = rng_array(13, (2, 5, 3, d))
    pos3 = np.random.default_rng(14).integers(0, 50, (2, 3, 5)).astype(
        np.int32)
    want = ref_layers.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), 1e6,
                                  sections)
    got = layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                             1e6, sections)
    close(got, want, PREFILL_TOL, "mrope")
    # text tokens: one id in all three channels is plain RoPE
    same = np.repeat(pos3[:, :1], 3, axis=1)
    close(layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(same),
                             1e6, sections),
          layers.apply_rope(torch.from_numpy(x), torch.from_numpy(same[:, 0]),
                            1e6), PREFILL_TOL, "text")


def test_layer_norm_gelu_mlp_and_sinusoids_match_reference():
    x = rng_array(15, (2, 7, 32), 2.0) + 1.5
    w, b = rng_array(16, (32,)), rng_array(17, (32,))
    close(layers.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(b)),
          ref_layers.layer_norm(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b)), PREFILL_TOL, "layer norm")
    p = {"fc1": rng_array(18, (32, 48), 0.3), "b1": rng_array(19, (48,)),
         "fc2": rng_array(20, (48, 32), 0.3), "b2": rng_array(21, (32,))}
    close(layers.gelu_mlp_apply({k: torch.from_numpy(v) for k, v in p.items()},
                                torch.from_numpy(x), torch.float32),
          ref_layers.gelu_mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                                    jnp.asarray(x), jnp.float32),
          PREFILL_TOL, "gelu mlp (tanh form)")
    for n, d in ((1500, 1280), (7, 6)):
        close(layers.sinusoid_positions(n, d),
              ref_layers.sinusoid_positions(n, d), PREFILL_TOL,
              f"sinusoids {n}x{d}")


# ----------------------------------------------------------------------
# the VLM stub's embeds path, serving, counts, dtypes, devices
# ----------------------------------------------------------------------

def test_mrope_embeds_path_matches_reference():
    """``forward(embeds=, positions=)`` with distinct (t, h, w) ids."""
    ref_cfg = ref_qwen2_vl.smoke()
    rparams, cfg, params = carried(ref_cfg)
    B, S = 2, 12
    embeds = rng_array(22, (B, S, cfg.d_model))
    pos3 = np.stack([np.arange(S), np.arange(S) // 3, np.arange(S) % 4]
                    ).astype(np.int32)[None].repeat(B, 0)
    want, _ = jax.jit(ref_build(ref_cfg).forward_train)(
        rparams, embeds=jnp.asarray(embeds), positions=jnp.asarray(pos3))
    got, _ = build_model(cfg).forward(params, embeds=torch.from_numpy(embeds),
                                      positions=torch.from_numpy(pos3))
    close(got, want, PREFILL_TOL, "logits")
    lw, _ = jax.jit(ref_build(ref_cfg).prefill)(rparams,
                                                embeds=jnp.asarray(embeds))
    lg, _ = build_model(cfg).prefill(params, embeds=torch.from_numpy(embeds))
    close(lg, lw, PREFILL_TOL, "prefill from embeds")


@pytest.mark.parametrize("ref_cfg", [
    ref_mixtral.smoke(), ref_deepseek.smoke(), ref_rwkv.smoke(),
    ref_qwen2_vl.smoke()], ids=lambda c: c.name)
def test_greedy_generate_matches_reference_engine(ref_cfg):
    """4 requests, 12-token prompts, 8 new tokens, greedy."""
    rparams, cfg, params = carried(ref_cfg)
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab, (4, 12)).astype(np.int32)
    want = RefEngine(ref_cfg, rparams, capacity=21, batch_size=4).generate(
        prompts, 8)
    got = ServeEngine(cfg, params, capacity=21, batch_size=4,
                      device="cpu").generate(prompts, 8)
    np.testing.assert_array_equal(got.tokens, want.tokens)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_of_full_configs_match_reference(arch):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    assert count_params_from_shapes(cfg) == ref_count(ref_cfg)
    assert count_active_params(cfg) == ref_active(ref_cfg)


#: leaves the reference reads in fp32 or as they are, never cast to the
#: compute dtype
FP32_LEAVES = {"scale", "bias", "w0", "u", "ln_scale", "ln_bias",
               "q_norm", "k_norm", "q_a_norm", "kv_a_norm"}


def _leaf_names(tree, key=None):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_names(v, k)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaf_names(v, key)
    else:
        yield key, tree


@pytest.mark.parametrize("make", [
    ref_mixtral.smoke, ref_deepseek.smoke, ref_rwkv.smoke,
    ref_qwen2_vl.smoke, ref_whisper.smoke], ids=lambda f: f.__module__.rsplit(
        ".", 1)[-1])
def test_bf16_outputs_and_caches_keep_reference_dtypes(make):
    """``dtype`` bf16 over fp32 parameters: the logits and every cache leaf
    have the reference's dtypes, and the engine's one-time cast leaves in
    fp32 only the leaves the reference reads in fp32."""
    ref_cfg = dataclasses.replace(make(), dtype=jnp.bfloat16)
    rparams, cfg, params = carried(ref_cfg)
    params = cast_for_compute(cfg, params, "cpu")
    for name, leaf in _leaf_names(params):
        want = torch.bfloat16 if name in COMPUTE_LEAVES else torch.float32
        assert leaf.dtype == want, name
        assert name in COMPUTE_LEAVES or name in FP32_LEAVES, name
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, (2, 6)).astype(
        np.int32)
    rmodel, model = ref_build(ref_cfg), build_model(cfg)
    if cfg.is_encdec:
        # the stub frontend hands the encoder frames in the compute dtype
        frames = rng_array(4, (2, cfg.encoder.n_frames, cfg.d_model))
        want, wstate = jax.jit(rmodel.prefill)(
            rparams, jnp.asarray(frames, jnp.bfloat16), jnp.asarray(tokens))
        got, gstate = model.prefill(
            params, torch.from_numpy(frames).to(torch.bfloat16),
            torch.from_numpy(tokens))
    else:
        want, wstate = jax.jit(rmodel.prefill)(rparams, jnp.asarray(tokens))
        got, gstate = model.prefill(params, torch.from_numpy(tokens))
    assert str(got.dtype).replace("torch.", "") == str(want.dtype)
    assert bool(torch.isfinite(got.float()).all())
    wleaves, gleaves = dict(_paths(wstate)), dict(_paths(gstate))
    assert list(gleaves) == list(wleaves)
    for path, leaf in wleaves.items():
        assert str(gleaves[path].dtype).replace("torch.", "") == \
            str(leaf.dtype), path


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def test_entry_points_need_cuda_unless_asked_for_cpu():
    """``init``, ``init_cache`` and ``lm_params_from_jax`` default to the
    card; without CUDA they raise and name ``device="cpu"``."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry points would run")
    gen = torch.Generator().manual_seed(0)
    for arch in ("mixtral_8x7b", "whisper_large_v3"):
        model = build_model(get_config(arch, reduced=True))
        with pytest.raises(RuntimeError, match='device="cpu"'):
            model.init(gen)
        with pytest.raises(RuntimeError, match='device="cpu"'):
            model.init_cache(2, 8)
        assert model.init(device="meta") is not None
    ref_cfg = ref_rwkv.smoke()
    rparams = jax.tree.map(np.asarray, jax.jit(ref_build(ref_cfg).init)(
        jax.random.key(0)))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        lm_params_from_jax(port_model_config(ref_cfg), rparams)


def test_launcher_serves_new_families_and_stops_for_whisper():
    from repro_torch.launch import serve
    out = serve.main(["--arch", "mixtral_8x7b", "--reduced", "--device",
                      "cpu", "--batch", "2", "--prompt-len", "6",
                      "--new-tokens", "3"])
    assert out.tokens.shape == (2, 3)
    with pytest.raises(SystemExit, match="encoder-decoder"):
        serve.main(["--arch", "whisper_large_v3", "--reduced", "--device",
                    "cpu"])


def test_decode_past_capacity_raises():
    """A decode position at the cache's capacity: the reference's scatter
    drops the write (``attention.py:237-238``); the port's in-place write
    refuses it."""
    rparams, cfg, params = carried(ref_mixtral.smoke())
    model = build_model(cfg)
    caches = model.init_cache(2, 4, device="cpu")
    with pytest.raises(IndexError):
        model.decode_step(params, torch.zeros(2, dtype=torch.int64),
                          torch.full((2,), 4), caches)
