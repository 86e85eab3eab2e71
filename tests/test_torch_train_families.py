"""The port's training path against the reference's for every arch's
smoke config, on the CPU.

For each of the ten ``configs/*.smoke()`` configs (fp32, remat "none"):
the reference's weights cross over with ``convert.lm_params_from_jax``,
the same numpy tokens (and whisper's frames) go through both losses
(``lm_loss``, with deepseek's MTP branch and the MoE aux loss;
``encdec_loss`` for whisper), and autograd's gradient of every leaf is
held to ``jax.value_and_grad``'s.  qwen2-vl also runs from ``embeds``
with distinct M-RoPE positions in its three channels.  Then one
``make_train_step`` step (AdamW, two microbatches) is held to the
reference's step.  On the CPU the port's attention and SSD scan run
their kernels' plain versions.

Tolerances: the loss within 1e-5 relative; each leaf's gradient
``max|Δg| <= 1e-4·max|g_ref| + 1e-6`` (fp32 in both, summed in other
orders).  After the step: grad_norm within 1e-5 relative, m within the
gradient's tolerance scaled by (1 - b1), v within 1e-3 relative of its
largest value plus 1e-12, and every parameter within 1e-5 of the
reference's (an AdamW step moves a parameter by at most lr = 1e-3;
1e-5 is 1% of that), except where the step's gradient lies within its
tolerance of zero: there roundoff decides the first step's direction
ĝ/(|ĝ| + eps), and the bound is 2·lr.  The reference's calls are
jitted, one compile an arch.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCH_IDS as REF_ARCH_IDS  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models.model import build_model as ref_build  # noqa: E402
from repro.optim.adamw import AdamWConfig as RefAdamWConfig  # noqa: E402
from repro.optim.adamw import adamw_init as ref_adamw_init  # noqa: E402
from repro.train.loss import cross_entropy as ref_ce  # noqa: E402
from repro.train.loss import encdec_loss as ref_encdec_loss  # noqa: E402
from repro.train.loss import lm_loss as ref_lm_loss  # noqa: E402
from repro.train.step import TrainStepConfig as RefStepConfig  # noqa: E402
from repro.train.step import make_train_step as ref_make_step  # noqa: E402
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.train.loss import cross_entropy  # noqa: E402
from repro_torch.train.loss import encdec_loss, lm_loss  # noqa: E402
from repro_torch.train.step import (  # noqa: E402
    TrainStepConfig,
    make_train_step,
)
from repro_torch.utils import tree_leaves, tree_map  # noqa: E402
from test_torch_models import by_path  # noqa: E402
from torch_port_util import port_model_config  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
PARAM_ATOL = 1e-5
B, S = 4, 17          # S tokens: 16 positions of next-token targets
LR = 1e-3
#: the share of a leaf whose first-step direction roundoff may decide
UNDECIDED_SHARE = 0.01


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for these small tensors: the suite's parallel
    workers would otherwise oversubscribe the cores many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def value_and_grad(loss_fn, params, *args):
    """(loss, metrics, grads) of a port loss, by autograd."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
        p.grad = None
    loss, metrics = loss_fn(params, *args)
    loss.backward()
    grads = tree_map(lambda p: (p.grad if p.grad is not None
                                else torch.zeros_like(p)), params)
    for p in leaves:
        p.grad = None
        p.requires_grad_(False)
    return loss.detach(), metrics, grads


def assert_grads_close(got, want):
    got, want = by_path(got), by_path(want)
    assert list(got) == list(want)
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape, path
        gap = float(np.abs(g - w).max())
        bound = GRAD_RTOL * float(np.abs(w).max()) + GRAD_ATOL
        assert gap <= bound, f"{path}: max|Δg| {gap:.3g} > {bound:.3g}"


class Case:
    """One arch's smoke config in both packages, its weights and data."""

    def __init__(self, arch):
        self.rcfg = ref_get_config(arch, reduced=True)
        self.cfg = port_model_config(self.rcfg)
        self.rmodel, self.model = ref_build(self.rcfg), build_model(self.cfg)
        self.rparams = jax.jit(self.rmodel.init)(jax.random.key(0))
        self.np_params = jax.tree.map(np.asarray, self.rparams)
        rng = np.random.default_rng(7)
        self.tokens = rng.integers(0, self.cfg.vocab, (B, S)).astype(
            np.int32)
        self.frames = None
        if self.cfg.is_encdec:
            self.frames = rng.normal(
                size=(B, self.cfg.encoder.n_frames, self.cfg.d_model)
            ).astype(np.float32)

    def params(self):
        return lm_params_from_jax(self.cfg, self.np_params, device="cpu")

    def ref_loss(self, p, toks):
        if self.frames is not None:
            return ref_encdec_loss(self.rcfg, self.rmodel, p,
                                   jnp.asarray(self.frames[:toks.shape[0]]),
                                   toks)
        return ref_lm_loss(self.rcfg, self.rmodel, p, toks)

    def loss(self, p, toks):
        if self.frames is not None:
            return encdec_loss(self.cfg, self.model, p,
                               torch.from_numpy(self.frames[:toks.shape[0]]),
                               toks)
        return lm_loss(self.cfg, self.model, p, toks)


@pytest.fixture(scope="module", params=ARCH_IDS)
def case(request):
    c = Case(request.param)
    # the reference's loss and grads, and one step from a fresh AdamW
    # state, in one compile
    ref_step = ref_make_step(
        c.rcfg, c.rmodel, RefAdamWConfig(lr=LR),
        RefStepConfig(num_microbatches=2), loss_fn=c.ref_loss)

    def both(p, toks):
        vg = jax.value_and_grad(c.ref_loss, has_aux=True)(p, toks)
        return vg, ref_step(p, ref_adamw_init(p), toks, 0)

    c.ref_out = jax.jit(both)(c.rparams, jnp.asarray(c.tokens))
    return c


def test_arch_lists_agree():
    assert ARCH_IDS == REF_ARCH_IDS


def test_loss_and_every_gradient_match_reference(case):
    ((want_loss, want_m), want_g), _ = case.ref_out
    loss, metrics, grads = value_and_grad(
        case.loss, case.params(), torch.from_numpy(case.tokens))
    np.testing.assert_allclose(float(loss), float(want_loss),
                               rtol=LOSS_RTOL)
    assert set(metrics) == set(want_m)
    for k in want_m:
        np.testing.assert_allclose(float(metrics[k].detach()),
                                   float(want_m[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    assert_grads_close(grads, want_g)


def test_train_step_matches_reference(case):
    _, (want_p, want_o, want_m) = case.ref_out
    params = case.params()
    before = by_path(case.params())
    step = make_train_step(case.cfg, case.model, AdamWConfig(lr=LR),
                           TrainStepConfig(num_microbatches=2),
                           loss_fn=case.loss)
    p, o, m = step(params, adamw_init(params),
                   torch.from_numpy(case.tokens), 0)
    assert set(m) == set(want_m)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(want_m["grad_norm"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(m["loss"]), float(want_m["loss"]),
                               rtol=LOSS_RTOL)
    assert int(o["step"]) == int(want_o["step"]) == 1
    gm, wm = by_path(o["m"]), by_path(want_o["m"])
    undecided = {}
    for path in wm:
        bound = (GRAD_RTOL * float(np.abs(wm[path]).max())
                 + (1 - 0.9) * GRAD_ATOL)
        assert float(np.abs(gm[path] - wm[path]).max()) <= bound, path
        # m exactly 0 in both (an embedding row no token picked): no
        # direction to decide, the step is decay alone
        undecided[path] = ((np.abs(wm[path]) <= bound)
                           & ((wm[path] != 0) | (gm[path] != 0)))
    # a first AdamW step moves p by lr·(ĝ/(|ĝ| + eps) + wd·p): where the
    # step's gradient (m / (1 - b1)) lies within its tolerance of zero,
    # roundoff decides that direction, and p may land up to 2·lr from the
    # reference's, though it still moves at most lr·(1 + wd·|p|).  Few
    # elements need that slack: at most UNDECIDED_SHARE of a leaf, or one
    got, want = by_path(p), by_path(want_p)
    assert list(got) == list(want)
    wd = AdamWConfig().weight_decay
    for path in want:
        band = undecided[path]
        moved = np.abs(got[path] - before[path])[band]
        assert (moved <= LR * (1 + wd * np.abs(before[path][band]))
                + PARAM_ATOL).all(), (path, float(moved.max()))
        gap = np.abs(got[path] - want[path])
        slack = gap > PARAM_ATOL
        assert (gap <= np.where(band, 2 * LR + PARAM_ATOL,
                                PARAM_ATOL)).all(), (
            path, float(gap.max()), int(slack.sum()))
        assert slack.sum() <= max(1, UNDECIDED_SHARE * slack.size), (
            path, int(slack.sum()), slack.size)
    gv, wv = by_path(o["v"]), by_path(want_o["v"])
    for path in wv:
        bound = 1e-3 * float(np.abs(wv[path]).max()) + 1e-12
        assert float(np.abs(gv[path] - wv[path]).max()) <= bound, path


def test_vlm_from_embeds_with_mrope_positions():
    """qwen2-vl's stub path: embeddings in, three distinct M-RoPE position
    channels (text, height, width ids), the loss and every gradient."""
    c = Case("qwen2_vl_7b")
    rng = np.random.default_rng(3)
    embeds = rng.normal(size=(2, 12, c.cfg.d_model)).astype(np.float32)
    pos = np.stack([np.arange(12), np.arange(12) // 4,
                    np.arange(12) % 4])[None].repeat(2, 0).astype(np.int32)
    targets = rng.integers(0, c.cfg.vocab, (2, 12)).astype(np.int32)

    def ref_loss(p):
        logits, _ = c.rmodel.forward_train(p, embeds=jnp.asarray(embeds),
                                           positions=jnp.asarray(pos))
        return ref_ce(logits, jnp.asarray(targets))

    want_loss, want_g = jax.jit(jax.value_and_grad(ref_loss))(c.rparams)

    def loss(p):
        logits, _ = c.model.forward_train(
            p, embeds=torch.from_numpy(embeds),
            positions=torch.from_numpy(pos))
        return cross_entropy(logits, torch.from_numpy(targets)), {}

    got_loss, _, grads = value_and_grad(loss, c.params())
    np.testing.assert_allclose(float(got_loss), float(want_loss),
                               rtol=LOSS_RTOL)
    assert_grads_close(grads, want_g)
