"""The Riemannian Adam kernel pair (``csrc/riemannian_adam.cu``,
``ops/riemannian_adam.py``): its dispatch and table on the CPU, and on a
card against the op sequence it replaces.

``RiemannianAdam`` chooses its path once, at construction: f32 parameters
on one CUDA device with f32 moments and no EMA take the kernel pair;
anything else the op sequence, which the JAX-parity tests of
``test_torch_port_optim.py`` hold. On a card the pair is held to the op
sequence run on the same card over the same gradients (the twin optimizer
with ``kernel = None``):

  * Euclidean tensors, both moments and ``count``: bit for bit (the same
    f32 operations in the same order, built with -fmad=false);
  * ball rows (points, exp_avg, exp_avg_sq): every row of every step. Each
    step starts the three runs from one state (the float64 run's, rounded
    to f32), and over the steps a tensor's largest row distance from the
    op sequence run in float64 on the CPU is at most ``BALL_K`` times the
    f32 op sequence's, plus 1e-6 of the tensor's largest value. The pair
    runs K3's ``point_step``, which rounds lambda^2 g_r^2 of the second
    moment in another order than the op sequence's ``component_inner``,
    sums a row of width 3 in another order, and projects the new point once
    where the op sequence projects it twice. Those last bits do not stay
    small: exp_avg is carried to the new point by the gyration, nested
    Mobius additions that take a ~1e-3 moment as the difference of terms of
    norm ~1, so each f32 path keeps ~1e-5 of error in it after one step.
    Left to run on, the two f32 paths part from float64 on trajectories of
    their own, and near the boundary one of them may lie 80x farther than
    the other after ten steps (both alike, on an H100); from one state a
    step at a time the two stay within a few times each other.
The card tests skip without one; on a machine without JAX run them with
``python -m pytest --noconftest -m cuda tests/test_torch_port_optim_kernel.py``.
"""

import types

import numpy as np
import pytest
import torch

from hyperbolic_vae_tpu_torch.manifolds import PoincareBall
from hyperbolic_vae_tpu_torch.nn import ManifoldParameter
from hyperbolic_vae_tpu_torch.ops import riemannian_adam as kernel_pair
from hyperbolic_vae_tpu_torch.optim import RiemannianAdam


def _flagship(device):
    from hyperbolic_vae_tpu_torch.models import GyroplaneVAE

    model = GyroplaneVAE(generator=torch.Generator().manual_seed(0), device=device)
    return list(model.parameters())


def _exp8(device):
    from hyperbolic_vae_tpu_torch.models import UnifiedVAE

    m = UnifiedVAE(input_size=(20480,), hidden_layer_dim=100, latent_dim=2, prior_scale=2.0,
                   beta=0.5, last_activation="sigmoid", generator=torch.Generator().manual_seed(0),
                   device=device)
    return list(m.parameters())


def _flagship_latent10(device):
    """The flagship at latent 10: ball rows wider than K3's."""
    from hyperbolic_vae_tpu_torch.models import GyroplaneVAE

    model = GyroplaneVAE(latent_dim=10, generator=torch.Generator().manual_seed(0), device=device)
    return list(model.parameters())


def _ragged(device):
    """Sizes 1, 3, 37, 4k + 1 and three tiles and a bit; one tensor at an
    address 4 bytes past 16-byte alignment (the kernels' scalar path); ball
    rows of width 2 (5 rows), 3 (300 rows: two row tiles) and 10 (7 rows)."""
    g = torch.Generator().manual_seed(1)
    out = [torch.nn.Parameter(torch.randn(n, generator=g).to(device))
           for n in (1, 3, 37, 4 * 1024 + 1, 3 * 4096 + 5)]
    out.append(torch.nn.Parameter(torch.randn(1 + 64 * 7, generator=g).to(device)[1:]))
    out.append(torch.nn.Parameter(torch.randn(6, 5, generator=g).to(device)))
    ball = PoincareBall(1.0)
    for rows, width in ((5, 2), (300, 3), (7, 10)):
        points = ball.expmap0(0.5 * torch.randn(rows, width, generator=g))
        out.append(ManifoldParameter(points.to(device)))
    return out


def _many(device):
    """More tensors than a launch takes (MAX_TENSORS): 300 Euclidean
    tensors of 1 to 600 elements and ball rows at both ends."""
    g = torch.Generator().manual_seed(2)
    ball = PoincareBall(1.0)
    out = [ManifoldParameter(ball.expmap0(0.5 * torch.randn(9, 2, generator=g)).to(device))]
    out += [torch.nn.Parameter(torch.randn(1 + (7 * i) % 600, generator=g).to(device))
            for i in range(300)]
    out.append(ManifoldParameter(ball.expmap0(0.5 * torch.randn(4, 5, generator=g)).to(device)))
    return out


MODELS = {"flagship": _flagship, "exp8": _exp8, "ragged": _ragged,
          "flagship_latent10": _flagship_latent10, "many": _many}


# ---- the dispatch and the table, on the CPU --------------------------------------


def _fake(device="cuda:0", dtype=torch.float32):
    return types.SimpleNamespace(device=torch.device(device), dtype=dtype)


@pytest.mark.parametrize("case, params, moment_dtype, ema, want", [
    ("card f32", [_fake(), _fake()], None, None, True),
    ("card f32, f32 moments", [_fake()], torch.float32, None, True),
    ("card bf16", [_fake(dtype=torch.bfloat16)], None, None, False),
    ("card float64", [_fake(dtype=torch.float64)], None, None, False),
    ("card f32, bf16 moments", [_fake()], torch.bfloat16, None, False),
    ("card f32, EMA", [_fake()], None, 0.99, False),
    ("two cards", [_fake(), _fake("cuda:1")], None, None, False),
    ("one f32 tensor beside a bf16", [_fake(), _fake(dtype=torch.bfloat16)], None, None, False),
    ("cpu", [_fake("cpu")], None, None, False),
    ("more tensors than a launch takes", [_fake()] * (kernel_pair.MAX_TENSORS + 1), None, None,
     True),
])
def test_dispatch_rule(case, params, moment_dtype, ema, want):
    assert kernel_pair.takes(params, moment_dtype, ema) is want, case


@pytest.mark.parametrize("kind", ["f32", "float64", "bf16 params", "bf16 moments", "ema"])
def test_cpu_tensors_take_the_op_sequence(kind):
    """On the CPU every storage type and the EMA run the op sequence: no
    kernel, its counter unchanged over three steps."""
    dtype = {"float64": torch.float64, "bf16 params": torch.bfloat16}.get(kind, torch.float32)
    params = [torch.nn.Parameter(t.to(dtype)) for t in (torch.randn(5, 3), torch.randn(7))]
    params.append(ManifoldParameter(PoincareBall(1.0).expmap0(0.3 * torch.randn(4, 2)).to(dtype)))
    opt = RiemannianAdam(params, lr=1e-2,
                         moment_dtype="bfloat16" if kind == "bf16 moments" else None,
                         ema_decay=0.9 if kind == "ema" else None)
    assert opt.kernel is None
    n0 = kernel_pair.launches.count
    for _ in range(3):
        for p in params:
            p.grad = torch.randn_like(p)
        opt.step()
    assert kernel_pair.launches.count == n0
    assert int(opt.count) == 3


@pytest.mark.parametrize("model", ["flagship", "exp8", "ragged", "many"])
def test_segment_table(model):
    """A segment a parameter in the optimizer's order (size, ball row width,
    group, scratch), the groups' f32 constants, and tiles (a block each)
    that cover every element of every segment once, in order, each of at
    most TILE_ELEMS elements; ball tiles hold whole rows, at most ROW_TILE;
    the ball rows' scratch, ROW_WORK floats an element, laid end to end."""
    params = MODELS[model]("cpu")
    if model == "ragged":  # two groups
        groups = [{"params": params[:4]}, {"params": params[4:], "betas": (0.8, 0.99), "eps": 1e-6,
                                            "weight_decay": 0.01}]
    else:
        groups = params
    opt = RiemannianAdam(groups, lr=1e-3)
    tab = kernel_pair.segment_table(opt)
    segs, tiles = tab["segs"], tab["tiles"]
    assert list(segs["n"]) == [p.numel() for p in params]
    assert list(segs["row"]) == [p.shape[-1] if isinstance(p, ManifoldParameter) else 0
                                 for p in params]
    assert list(segs["p"]) == [p.data_ptr() for p in params]
    assert list(segs["m"]) == [opt.state[p]["exp_avg"].data_ptr() for p in params]
    if model == "flagship":
        assert len(segs) == 14 and list(segs["row"]).count(2) == 1
    if model == "exp8":
        assert len(segs) == 10 and sorted(segs["n"])[-2:] == [20480 * 100] * 2
    if model == "many":
        assert len(segs) == 302 > kernel_pair.MAX_TENSORS
    work = 0
    for n, row, at in zip(segs["n"].tolist(), segs["row"].tolist(), segs["work"].tolist()):
        assert at == (work if row else 0)
        work += kernel_pair.ROW_WORK * n if row else 0
    assert tab["work"] == work
    want_group = [0] * 4 + [1] * (len(params) - 4) if model == "ragged" else [0] * len(params)
    assert list(segs["group"]) == want_group
    g = tab["groups"]
    assert g["b1"][0] == np.float32(0.9) and g["omb2"][0] == np.float32(1.0 - 0.999)
    assert list(g["lr"]) == [grp["lr"].data_ptr() for grp in opt.param_groups]
    if model == "ragged":
        assert g["eps"][1] == np.float32(1e-6) and g["wd"][1] == np.float32(0.01)
        assert g["omb1"][1] == np.float32(1.0 - 0.8)
    covered = {s: 0 for s in range(len(segs))}
    for seg, ln, start in tiles.tolist():
        assert start == covered[seg] and 0 < ln <= kernel_pair.TILE_ELEMS
        covered[seg] += ln
        row = int(segs["row"][seg])
        if row:
            assert start % row == 0 and ln % row == 0 and ln // row <= kernel_pair.ROW_TILE
    assert covered == {s: int(n) for s, n in enumerate(segs["n"])}
    assert list(tiles["seg"]) == sorted(tiles["seg"])


def test_segment_table_refuses_what_the_kernel_does_not_take():
    strided = torch.nn.Parameter(torch.randn(6, 4).t())
    with pytest.raises(ValueError, match="contiguous"):
        kernel_pair.segment_table(RiemannianAdam([strided]))


@pytest.mark.parametrize("finite", [True, False])
def test_step_with_guard_equals_the_trainers_guard_on_the_cpu(finite):
    """``step(guard=loss)`` on the op sequence: the same bits and the same
    ok as ``train_step``'s guard followed by ``step(ok=...)``."""
    params = _ragged("cpu")
    twin = [type(p)(p.detach().clone()) for p in params]
    opts = [RiemannianAdam(ps, lr=1e-2, ball=PoincareBall(1.0)) for ps in (params, twin)]
    g = torch.Generator().manual_seed(4)
    for _ in range(3):
        for p, q in zip(params, twin):
            p.grad = torch.randn(p.shape, generator=g)
            q.grad = p.grad.clone()
        if not finite:
            params[2].grad[5] = float("nan")
            twin[2].grad[5] = float("nan")
        loss = torch.tensor(1.5)
        ok = opts[0].step(guard=loss)
        g2 = torch.stack([(q.grad * q.grad).sum() for q in twin]).sum()
        want = torch.isfinite(loss) & torch.isfinite(g2)
        opts[1].step(ok=want)
        assert bool(ok) is finite and bool(want) is finite
    for p, q in zip(params, twin):
        assert torch.equal(p, q)
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(opts[0].state[p][k], opts[1].state[q][k])
    assert int(opts[0].count) == int(opts[1].count) == (3 if finite else 0)


# ---- on a card: the pair against the op sequence ---------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


# a ball tensor's largest row error: at most this times the op sequence's. The
# largest factor read on an H100: 4.14 (the ragged rows here, ``ok`` given),
# 2.31 over 60 seeded runs a model; a fault moves a row by its own size,
# 1e4 times the f32 error and more
BALL_K = 8.0


class _Twins:
    """Equal parameters stepped by the pair (``ka``), by the op sequence on
    the same card (``ops``) and, for the ball rows, by the op sequence in
    float64 on the CPU (``f64``, which takes the pair's ok), from the same
    gradients. After each step (``settle``) each run's largest row distance
    from float64 is kept (``worst``), and the three runs' ball rows (points
    and both moments) are set to the float64 run's, rounded to f32: every
    step starts the three from one state."""

    def __init__(self, model, dev, **kw):
        self.params = MODELS[model](dev)
        self.twin = [type(p)(p.detach().clone()) for p in self.params]
        self.ball = {i: ManifoldParameter(p.detach().double().cpu())
                     for i, p in enumerate(self.params) if isinstance(p, ManifoldParameter)}
        self.ka = RiemannianAdam(self.params, ball=PoincareBall(1.0), **kw)
        self.ops = RiemannianAdam(self.twin, ball=PoincareBall(1.0), **kw)
        self.ops.kernel = None
        self.f64 = RiemannianAdam(list(self.ball.values()), ball=PoincareBall(1.0), **kw)
        assert self.ka.kernel is not None and self.f64.kernel is None
        self.worst = {}  # (ball index, tensor) -> [pair's, op sequence's, largest |value|]

    def grads(self, g, scale=0.1):
        for i, (p, q) in enumerate(zip(self.params, self.twin)):
            p.grad = scale * torch.randn(p.shape, generator=g, device=p.device)
            q.grad = p.grad.clone()
            if i in self.ball:
                self.ball[i].grad = p.grad.double().cpu()

    def poison(self, i, index):
        """A NaN in parameter i's gradient, on every twin."""
        for t in [self.params[i], self.twin[i]] + ([self.ball[i]] if i in self.ball else []):
            t.grad.view(-1)[index] = float("nan")

    def settle(self):
        """After a step: ``record_ball``, then every run's ball rows set to
        the float64 run's rounded to f32, in place (the pair's table keeps
        its addresses)."""
        self.record_ball()
        with torch.no_grad():
            self._sync_ball()

    def _sync_ball(self):
        for i, f in self.ball.items():
            for t64, ta, tb in zip(self._tensors(self.f64, f), self._tensors(self.ka, self.params[i]),
                                   self._tensors(self.ops, self.twin[i])):
                t32 = t64.detach().float()
                t64.copy_(t32.double())
                ta.copy_(t32)
                tb.copy_(t32)

    def record_ball(self):
        """Each ball tensor's largest row distance from float64, for the
        pair and the op sequence, kept as the worst over the steps."""
        for i, f in self.ball.items():
            for k, (t64, ta, tb) in enumerate(zip(
                    self._tensors(self.f64, f), self._tensors(self.ka, self.params[i]),
                    self._tensors(self.ops, self.twin[i]))):
                ref = t64.detach()
                now = [float((t.detach().double().cpu() - ref).norm(dim=-1).max()) for t in (ta, tb)]
                w = self.worst.setdefault((i, k), [0.0, 0.0, 0.0])
                w[0], w[1] = max(w[0], now[0]), max(w[1], now[1])
                w[2] = max(w[2], float(ref.abs().max()))

    def step(self, loss=None, ok=None, guard=True):
        """A guarded step (the op sequence with train_step's guard), or with
        ``ok`` given, or (``guard=False``) unguarded, then ``settle``;
        returns the pair's ok."""
        if guard and ok is None:
            got = self.ka.step(guard=loss)
            g2 = torch.stack([(q.grad * q.grad).sum() for q in self.twin]).sum()
            want = torch.isfinite(loss) & torch.isfinite(g2)
            self.ops.step(ok=want)
            assert bool(got) == bool(want)
            self.f64.step(ok=got.cpu())
        else:
            got = ok
            self.ka.step(ok=ok)
            self.ops.step(ok=ok)
            self.f64.step(ok=None if ok is None else ok.cpu())
        self.settle()
        return got

    @staticmethod
    def _tensors(opt, p):
        return (p, opt.state[p]["exp_avg"], opt.state[p]["exp_avg_sq"])

    def set_lr(self, lr):
        for o in (self.ka, self.ops, self.f64):
            o.set_lr(lr)

    def state(self, opt, ps):
        return [t.detach().clone() for p in ps
                for t in (p, opt.state[p]["exp_avg"], opt.state[p]["exp_avg_sq"])]

    def ball_ratios(self):
        """For each ball tensor (points, exp_avg, exp_avg_sq): the pair's
        largest row distance from float64 over all steps, over BALL_K times
        the op sequence's plus 1e-6 of the tensor's largest value."""
        return [mine / (BALL_K * theirs + 1e-6 * big)
                for mine, theirs, big in self.worst.values()]

    def compare(self):
        """Euclidean tensors, both moments and count bit for bit; each ball
        tensor's ``ball_ratios`` at most 1."""
        assert int(self.ka.count) == int(self.ops.count) == int(self.f64.count)
        for i, (p, q) in enumerate(zip(self.params, self.twin)):
            if i not in self.ball:
                for a, b in zip(self.state(self.ka, [p]), self.state(self.ops, [q])):
                    assert torch.equal(a, b), (i, tuple(p.shape), float((a - b).abs().max()))
        assert max(self.ball_ratios(), default=0.0) <= 1.0, self.ball_ratios()


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["flagship", "exp8", "ragged", "flagship_latent10", "many"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_kernel_matches_op_sequence_over_10_steps(model, weight_decay):
    dev = _card()
    tw = _Twins(model, dev, lr=1e-2, weight_decay=weight_decay)
    g = torch.Generator(device=dev).manual_seed(7)
    loss = torch.tensor(2.5, device=dev)
    n0 = kernel_pair.launches.count
    for _ in range(10):
        tw.grads(g)
        assert bool(tw.step(loss))
    assert kernel_pair.launches.count == n0 + 10
    tw.compare()
    assert int(tw.ka.count) == 10


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["gradient", "loss"])
def test_not_ok_step_changes_nothing(where):
    """A NaN gradient (or loss) after three steps: ok false, parameters,
    both moments and count bit for bit as before, as the op sequence's."""
    dev = _card()
    tw = _Twins("flagship", dev, lr=1e-2)
    g = torch.Generator(device=dev).manual_seed(3)
    loss = torch.tensor(1.0, device=dev)
    for _ in range(3):
        tw.grads(g)
        tw.step(loss)
    before = tw.state(tw.ka, tw.params)
    tw.grads(g)
    if where == "gradient":
        tw.poison(4, 1)
    else:
        loss.fill_(float("inf"))
    assert not bool(tw.step(loss))
    assert all(torch.equal(a, b) for a, b in zip(before, tw.state(tw.ka, tw.params)))
    assert int(tw.ka.count) == 3
    tw.compare()


@pytest.mark.cuda
def test_given_ok_and_no_guard():
    """``step(ok=...)`` (a layout's or clipping's guard) and ``step()`` (the
    guard off) on the pair: as the op sequence's."""
    dev = _card()
    tw = _Twins("ragged", dev, lr=1e-2)
    g = torch.Generator(device=dev).manual_seed(5)
    for ok in (True, False, None, True):
        tw.grads(g)
        tw.step(ok=None if ok is None else torch.tensor(ok, device=dev), guard=False)
    tw.compare()
    assert int(tw.ka.count) == 3


@pytest.mark.cuda
def test_lr_written_between_graph_replays_is_read():
    """The pair captured in a CUDA graph reads lr from the device: replays
    at lr 1e-2, then 3e-3 written with ``set_lr``, equal the op sequence
    stepped eagerly at the same lrs."""
    from hyperbolic_vae_tpu_torch.train.cuda_graph import no_collection

    dev = _card()
    tw = _Twins("flagship", dev, lr=1e-2)
    g = torch.Generator(device=dev).manual_seed(11)
    tw.grads(g)
    loss = torch.tensor(0.5, device=dev)
    tw.step(loss)  # builds and loads the library outside the capture
    graph = torch.cuda.CUDAGraph()
    with no_collection(), torch.cuda.graph(graph):
        ok = tw.ka.step(guard=loss)
    n0 = kernel_pair.launches.count
    for lr in (1e-2, 1e-2, 3e-3, 3e-3):
        tw.set_lr(lr)
        graph.replay()
        g2 = torch.stack([(q.grad * q.grad).sum() for q in tw.twin]).sum()
        tw.ops.step(ok=torch.isfinite(loss) & torch.isfinite(g2))
        tw.f64.step(ok=ok.cpu())
        tw.settle()
    torch.cuda.synchronize()
    assert kernel_pair.launches.count == n0  # a replay does not call the wrapper
    tw.compare()
    assert int(tw.ka.count) == 5


@pytest.mark.cuda
def test_guard_on_and_off_give_the_same_bits_on_card():
    """``Trainer(finite_guard=True)`` and ``False`` on the card (graphed):
    the same history and parameters bit for bit on a finite run, as
    ``test_torch_port_finite_guard.py`` holds on the CPU; the pair launched
    once a train step in both."""
    from hyperbolic_vae_tpu_torch.data import ArrayDataModule, synthetic_mnist_arrays
    from hyperbolic_vae_tpu_torch.models import GyroplaneVAE
    from hyperbolic_vae_tpu_torch.train import Trainer

    dev = _card()
    x, y, xt, yt = synthetic_mnist_arrays(288, 32, seed=5)

    def fit(guard):
        dm = ArrayDataModule(x[:256], y[:256], x[256:], y[256:], xt, yt, batch_size=64)
        model = GyroplaneVAE(generator=torch.Generator().manual_seed(3), device=dev)
        t = Trainer(model, max_epochs=3, early_stopping_patience=None, finite_guard=guard,
                    device=dev)
        n0 = kernel_pair.launches.count
        res = t.fit(dm)
        assert kernel_pair.launches.count - n0 == 3 * 4
        return res

    on, off = fit(True), fit(False)
    assert on.history == off.history
    assert all(row["train/skipped_steps"] == 0 for row in on.history)
    for d in ("params", "best_params"):
        for name, v in getattr(on, d).items():
            assert torch.equal(v, getattr(off, d)[name]), (d, name)
