"""The optax rules and schedules of ``fv3net_torch/fit/{optimizers,
schedules,linesearch}.py`` that the dense trainer's first ports left out,
held against optax 0.2.6 in float64: ten updates of each of the 18 rules
on one list of leaves and gradients made from a numpy seed (a bias, a 2-D
weight, a 3-D tensor for sm3's per-axis accumulators and one wide enough
for adafactor to factor), the kwargs that switch a branch as cases of one
test; lbfgs with its zoom line search and polyak_sgd on a small MLP's
loss; noisy_sgd with optax's noise handed over; the 5 schedules at counts
0-20; the dense trainer with three of the rules against the reference's;
and the configurations for which optax raises."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_port_util  # noqa: F401  (torch threads under xdist)

from fv3net_torch.fit import config as tconfig
from fv3net_torch.fit import dense as tdense
from fv3net_torch.fit import optimizers as toptimizers
from fv3net_torch.fit import schedules as tschedules
from test_torch_dense_training import (
    NAMES_IN,
    NAMES_OUT,
    RTOL,
    _batches,
    _columns,
    _hand_over,
    _sizes,
)

jax.config.update("jax_enable_x64", True)

#: ten float64 updates: roundoff only, relative to each leaf's scale
UPDATE_RTOL = 1e-12
#: a bias, a weight wide enough for adafactor to factor at its default
#: min_dim_size_to_factor (128) and a 3-D tensor for sm3's per-axis
#: accumulators
SHAPES = [(5,), (128, 132), (4, 2, 3)]


def _leaves(seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s) for s in SHAPES]


def _gradients(steps=10, seed=1):
    rng = np.random.RandomState(seed)
    return [[rng.randn(*s) for s in SHAPES] for _ in range(steps)]


def _weights_only(params):
    """A mask callable of both packages' flat lists: True off the bias."""
    return [p.ndim > 1 for p in params]


def _assert_close(got, want, rtol=UPDATE_RTOL, what=""):
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype == np.float64, (what, i)
        err = np.abs(a - b).max() / np.abs(b).max()
        assert err <= rtol, (what, i, err)


def _xla_adafactor_decay(self):
    """optax's float32 decay of adafactor's second moment, computed by
    XLA: its float32 power is an ulp off the correctly rounded one (which
    torch's is) at about a quarter of the counts, and adafactor's
    update carries that 6e-8 into every leaf, so the tests hand it over."""
    t = jnp.asarray(self.count - self.decay_offset, jnp.float32)
    return torch.tensor(np.asarray(1.0 - t ** -self.decay_rate))


def _xla_power32(x, y):
    return np.asarray(jnp.float32(x) ** jnp.float32(y))


@pytest.fixture
def xla_decay(monkeypatch):
    monkeypatch.setattr(toptimizers.Adafactor, "second_moment_decay",
                        _xla_adafactor_decay)


@pytest.fixture
def xla_power(monkeypatch):
    """optax's float32 powers in the port's schedules (exponential decay's
    decay_rate ** p), for the same reason."""
    monkeypatch.setattr(tschedules, "power32", _xla_power32)


def test_float32_powers_are_within_an_ulp_of_xla():
    """What the two seams above hand over: the port's own float32 powers
    (correctly rounded) and XLA's differ by at most one float32 ulp, at
    counts 1-400."""
    port = tconfig.OptimizerConfig("adafactor").instance
    ulp = np.finfo(np.float32).eps
    for count in range(1, 401):
        port.count = count
        mine = float(port.second_moment_decay())
        xla = float(_xla_adafactor_decay(port))
        assert abs(mine - xla) <= ulp * abs(xla), count
        p = np.float32(count) / np.float32(7)
        mine, xla = tschedules.power32(0.9, p), _xla_power32(0.9, p)
        assert abs(float(mine) - float(xla)) <= ulp * float(xla), count


def _run_both(tx, port, grads):
    """Apply the same gradients through optax's transform (jitted: one
    compilation a case costs less than eager dispatch's one a primitive
    and shape) and the port's rule from the same leaves; each side's
    leaves after the last."""
    p0 = _leaves()
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    update = jax.jit(tx.update)
    tp = [torch.tensor(p) for p in p0]
    for g in grads:
        upd, state = update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        port.step(tp, [torch.tensor(x) for x in g])
    return [p.numpy() for p in tp], [np.asarray(p) for p in jp]


TAIL_CASES = [
    ("adadelta", {}),
    ("adadelta", {"learning_rate": 0.5, "weight_decay": 1e-2,
                  "weight_decay_mask": _weights_only}),
    ("adafactor", {}),
    ("adafactor", {"learning_rate": 1e-2, "min_dim_size_to_factor": 3,
                   "momentum": 0.9, "weight_decay_rate": 1e-3,
                   "decay_offset": -3, "weight_decay_mask": _weights_only}),
    ("adafactor", {"learning_rate": 1e-2, "multiply_by_parameter_scale":
                   False, "clipping_threshold": None, "factored": False,
                   "momentum": 0.5, "dtype_momentum": "float64"}),
    ("adamaxw", {"learning_rate": 1e-2}),
    ("adamaxw", {"learning_rate": 1e-2, "weight_decay": 1e-2,
                 "mask": _weights_only}),
    ("adan", {"learning_rate": 1e-2}),
    ("adan", {"learning_rate": 1e-2, "weight_decay": 1e-2}),
    ("fromage", {"learning_rate": 1e-2}),
    ("lamb", {"learning_rate": 1e-2}),
    ("lamb", {"learning_rate": 1e-2, "weight_decay": 1e-2,
              "mask": _weights_only}),
    ("lars", {"learning_rate": 1e-2}),
    ("lars", {"learning_rate": 1e-2, "nesterov": True, "weight_decay": 1e-2,
              "weight_decay_mask": _weights_only,
              "trust_ratio_mask": _weights_only}),
    ("lbfgs", {"linesearch": None}),
    ("lbfgs", {"learning_rate": 0.1, "memory_size": 3,
               "scale_init_precond": False, "linesearch": None}),
    ("nadamw", {"learning_rate": 1e-2}),
    ("nadamw", {"learning_rate": 1e-2, "mask": _weights_only,
                "mu_dtype": "float32"}),
    ("novograd", {"learning_rate": 1e-2}),
    ("novograd", {"learning_rate": 1e-2, "weight_decay": 1e-2}),
    ("optimistic_adam", {"learning_rate": 1e-2}),
    ("optimistic_adam", {"learning_rate": 1e-2, "optimism": 0.1}),
    ("optimistic_adam_v2", {"learning_rate": 1e-2}),
    ("optimistic_adam_v2", {"learning_rate": 1e-2, "alpha": 0.5,
                            "beta": 2.0, "nesterov": False}),
    ("optimistic_gradient_descent", {"learning_rate": 1e-2}),
    ("optimistic_gradient_descent", {"learning_rate": 1e-2, "alpha": 0.5,
                                     "beta": 2.0}),
    ("rprop", {"learning_rate": 1e-2}),
    ("sign_sgd", {"learning_rate": 1e-2}),
    ("sm3", {"learning_rate": 1e-2}),
]


def _optax_kwargs(kwargs):
    """The config's kwargs as optax takes them (a dtype's name as a JAX
    dtype)."""
    out = dict(kwargs)
    for key in ("mu_dtype", "dtype_momentum"):
        if isinstance(out.get(key), str):
            out[key] = jnp.dtype(out[key])
    return out


@pytest.mark.parametrize("name,kwargs", TAIL_CASES)
def test_tail_rules_match_optax(xla_decay, name, kwargs):
    """Ten float64 updates of each rule, with optax's defaults and each
    branch switched by its kwargs, through ``OptimizerConfig``."""
    tx = getattr(optax, name)(**_optax_kwargs(kwargs))
    port = tconfig.OptimizerConfig(name, kwargs).instance
    got, want = _run_both(tx, port, _gradients())
    _assert_close(got, want, what=(name, kwargs))


def test_adafactor_factors_the_wide_leaf():
    """At optax's default ``min_dim_size_to_factor`` (128) the 128 x 132
    leaf has row and column accumulators and the others a full one."""
    port = tconfig.OptimizerConfig("adafactor").instance
    tp = [torch.tensor(p) for p in _leaves()]
    port.step(tp, [torch.tensor(g) for g in _gradients(1)[0]])
    assert [sorted(s) for s in port._state] == [
        ["v"], ["v_col", "v_row"], ["v"]]


def test_schedule_rates_match_optax_under_fromage_and_lamb():
    """A schedule as the rate: fromage's decay reads optax's never-counted
    schedule state (the count 0 at every update), lamb's rate the count."""
    for name, sched in (
            ("fromage", ("warmup_constant_schedule",
                         {"init_value": 0.0, "peak_value": 0.1,
                          "warmup_steps": 4})),
            ("lamb", ("sgdr_schedule", {"cosine_kwargs": [
                {"init_value": 0.0, "peak_value": 1e-2, "warmup_steps": 2,
                 "decay_steps": 5}] * 2}))):
        tx = getattr(optax, name)(getattr(optax, sched[0])(**sched[1]))
        port = tconfig.OptimizerConfig(
            name, {}, tconfig.LearningRateScheduleConfig(*sched)).instance
        got, want = _run_both(tx, port, _gradients())
        _assert_close(got, want, what=name)


# --------------------------------------------- rules that take the loss
MLP_SIZES = [6, 8, 3]


def _mlp_problem(seed=3):
    """A float64 two-layer tanh MLP's mean-square loss on 32 samples: the
    initial leaves, the loss of a list of leaves in each package."""
    rng = np.random.RandomState(seed)
    x, y = rng.randn(32, MLP_SIZES[0]), rng.randn(32, MLP_SIZES[-1])
    p0 = []
    for a, b in zip(MLP_SIZES[:-1], MLP_SIZES[1:]):
        p0 += [rng.randn(a, b) / np.sqrt(a), 0.1 * rng.randn(b)]

    def loss(leaves, xp):
        h = xp.asarray(x) if xp is jnp else torch.tensor(x)
        for i in range(0, len(leaves), 2):
            h = h @ leaves[i] + leaves[i + 1]
            if i + 2 < len(leaves):
                h = xp.tanh(h)
        t = xp.asarray(y) if xp is jnp else torch.tensor(y)
        return xp.mean((h - t) ** 2)

    return p0, (lambda ls: loss(ls, jnp)), (lambda ls: loss(ls, torch))


def _torch_value_and_grad(fn, leaves):
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    value = fn(leaves)
    return value.detach(), list(torch.autograd.grad(value, leaves))


def _solve_both(tx, name, kwargs, steps=10):
    p0, jfn, tfn = _mlp_problem()
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    port = tconfig.OptimizerConfig(name, kwargs).instance
    tp = [torch.tensor(p) for p in p0]
    update = jax.jit(tx.update, static_argnames="value_fn")
    losses = []
    for _ in range(steps):
        value, grad = jax.value_and_grad(jfn)(jp)
        upd, state = update(grad, state, jp, value=value, grad=grad,
                            value_fn=jfn)
        jp = optax.apply_updates(jp, upd)
        tvalue, tgrad = _torch_value_and_grad(tfn, tp)
        port.step(tp, tgrad, value=tvalue, grad=tgrad, value_fn=tfn)
        losses.append(float(tvalue))
    return [p.numpy() for p in tp], [np.asarray(p) for p in jp], losses


def test_lbfgs_zoom_linesearch_matches_optax():
    """lbfgs at optax's defaults, the zoom line search included, ten
    iterations on the MLP's full-batch loss: the leaves match and the
    loss does not increase."""
    got, want, losses = _solve_both(optax.lbfgs(), "lbfgs", {})
    _assert_close(got, want, what="lbfgs")
    assert all(b <= a for a, b in zip(losses, losses[1:])), losses
    assert losses[-1] < 0.5 * losses[0], losses


@pytest.mark.parametrize("kwargs", [
    {}, {"variant": "sps+", "f_min": 1.2, "max_learning_rate": 0.5},
    {"variant": "sps+", "f_min": 2.0}, {"scaling": 0.5, "eps": 1e-3}])
def test_polyak_sgd_matches_optax(kwargs):
    """polyak_sgd's step from the loss (``value``; 1.55 at the start),
    both variants: ``sps+`` with f_min 1.2 steps down onto it, with f_min
    above the loss its step is 0."""
    got, want, losses = _solve_both(optax.polyak_sgd(**kwargs),
                                    "polyak_sgd", kwargs)
    _assert_close(got, want, what=kwargs)
    if kwargs.get("f_min") == 2.0:
        assert losses == [losses[0]] * len(losses), losses


def test_zoom_linesearch_settings_match_optax():
    """The zoom line search alone with other settings (the 'keep' guess,
    a cap on the step, fewer steps, no approximate decrease): the step
    size it returns along the gradient, three times from one point."""
    from fv3net_torch.fit.linesearch import scale_by_zoom_linesearch

    p0, jfn, tfn = _mlp_problem(seed=5)
    for kwargs in ({"max_linesearch_steps": 20,
                    "initial_guess_strategy": "keep",
                    "max_learning_rate": 4.0},
                   {"max_linesearch_steps": 3, "approx_dec_rtol": None,
                    "increase_factor": 3.0, "curv_rtol": 0.1}):
        ls = optax.scale_by_zoom_linesearch(**kwargs)
        update = jax.jit(ls.update, static_argnames="value_fn")
        port = scale_by_zoom_linesearch(**kwargs)
        jp = [jnp.asarray(p) for p in p0]
        value, grad = jax.value_and_grad(jfn)(jp)
        direction = [-100.0 * g for g in grad]
        state = ls.init(jp)
        tp = [torch.tensor(p) for p in p0]
        tvalue, tgrad = _torch_value_and_grad(tfn, tp)
        prev = 1.0
        for _ in range(3):
            upd, state = update(direction, state, jp, value=value,
                                grad=grad, value_fn=jfn)
            want = float(state.learning_rate)
            got, *_ = port.scale(tp, [torch.tensor(np.asarray(d))
                                      for d in direction],
                                 value=tvalue, grad=tgrad, value_fn=tfn,
                                 prev_stepsize=prev)
            assert float(got) == pytest.approx(want, rel=1e-12), kwargs
            prev = float(got)


def test_noisy_sgd_matches_optax_with_its_noise(monkeypatch):
    """noisy_sgd with optax's noise handed over through the rule's
    ``noise`` (its draws recovered from optax's update as (u / -lr - g) /
    std, std = sqrt(eta / (1 + t)^gamma)): the rest of its update."""
    kwargs = {"learning_rate": 1e-2, "eta": 0.05, "gamma": 0.6, "key": 7}
    tx = optax.noisy_sgd(**kwargs)
    p0, grads = _leaves(), _gradients()
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    update = jax.jit(tx.update)
    draws = []
    for t, g in enumerate(grads):
        upd, state = update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        std = np.sqrt(0.05 / (t + 1) ** 0.6)
        draws += [(np.asarray(u) / -1e-2 - x) / std for u, x in zip(upd, g)]
    port = tconfig.OptimizerConfig("noisy_sgd", kwargs).instance
    handed = iter(draws)
    monkeypatch.setattr(port, "noise", lambda p: torch.tensor(next(handed)))
    tp = [torch.tensor(p) for p in p0]
    for g in grads:
        port.step(tp, [torch.tensor(x) for x in g])
    _assert_close([p.numpy() for p in tp], [np.asarray(p) for p in jp])


def test_noisy_sgd_draws_from_its_seeded_generator():
    """The port's own noise: a generator on the leaves' device seeded
    from ``key`` (or ``seed``), the same draws for the same seed, a
    variance that decays as eta / t^gamma."""
    def added(**kwargs):
        port = tconfig.OptimizerConfig("noisy_sgd", {
            "learning_rate": 1.0, "eta": 4.0, "gamma": 1.0, **kwargs}
        ).instance
        out = []
        for _ in range(2):
            p = torch.zeros(20000, dtype=torch.float64)
            port.step([p], [torch.zeros_like(p)])
            out.append(-p)
        return out

    a, b, c = added(key=3), added(seed=3), added(key=4)
    assert torch.equal(a[0], b[0]) and not torch.equal(a[0], c[0])
    assert float(a[0].var()) == pytest.approx(4.0, rel=0.05)
    assert float(a[1].var()) == pytest.approx(2.0, rel=0.05)
    with pytest.raises(ValueError):
        tconfig.OptimizerConfig("noisy_sgd", {
            "learning_rate": 1.0, "key": 1, "seed": 1}).instance


# ------------------------------------------------------------ schedules
def _join_kwargs(pkg):
    """join_schedules' arguments in each package: a warm-up, an
    exponential decay (float32 rates) and a cosine decay (float64)."""
    sched = (tconfig.LearningRateScheduleConfig if pkg == "port" else
             lambda name, kw: getattr(optax, name)(**kw))

    def make(name, kw):
        return sched(name, kw).instance if pkg == "port" else sched(name, kw)

    return {"schedules": [
        make("linear_schedule", {"init_value": 0.0, "end_value": 1e-2,
                                 "transition_steps": 4}),
        make("exponential_decay", {"init_value": 1e-2, "transition_steps": 3,
                                   "decay_rate": 0.5}),
        make("cosine_decay_schedule", {"init_value": 3e-3,
                                       "decay_steps": 6})],
        "boundaries": [4, 12]}


SCHEDULE_CASES = [
    ("join_schedules", None),
    ("linear_onecycle_schedule", {"transition_steps": 16,
                                  "peak_value": 1e-2}),
    ("linear_onecycle_schedule", {"transition_steps": 20, "peak_value": 0.1,
                                  "pct_start": 0.2, "pct_final": 0.6,
                                  "div_factor": 10.0,
                                  "final_div_factor": 100.0}),
    ("piecewise_interpolate_schedule", {
        "interpolate_type": "linear", "init_value": 1e-2,
        "boundaries_and_scales": {3: 0.5, 7: 2.0, 12: 0.1}}),
    ("piecewise_interpolate_schedule", {
        "interpolate_type": "cosine", "init_value": 1e-2,
        "boundaries_and_scales": {5: 0.1, 15: 0.5}}),
    ("sgdr_schedule", {"cosine_kwargs": [
        {"init_value": 0.0, "peak_value": 1e-2, "warmup_steps": 2,
         "decay_steps": 6},
        {"init_value": 1e-4, "peak_value": 5e-3, "warmup_steps": 3,
         "decay_steps": 8, "end_value": 1e-4}]}),
    ("warmup_constant_schedule", {"init_value": 1e-4, "peak_value": 1e-2,
                                  "warmup_steps": 5}),
]


@pytest.mark.parametrize("name,kwargs", SCHEDULE_CASES)
def test_tail_schedules_match_optax(xla_power, name, kwargs):
    """optax's rate at every count 0-20, as test_schedules_match_optax
    holds the 9 others (float32 where optax's int32 count makes it so)."""
    want = getattr(optax, name)(**(kwargs or _join_kwargs("optax")))
    got = tconfig.LearningRateScheduleConfig(
        name, kwargs or _join_kwargs("port")).instance
    for count in range(21):
        ref = float(want(jnp.asarray(count, jnp.int32)))
        assert got(count) == pytest.approx(ref, rel=1e-15, abs=0), count


def test_every_optax_name_resolves():
    """All 30 of optax 0.2.6's optimizer aliases build, and its 14
    schedules are there (test_unported_names_raise holds a name optax
    lacks)."""
    assert len(toptimizers.OPTIMIZERS) == 30
    for name in toptimizers.OPTIMIZERS:
        assert callable(getattr(optax, name))
        tconfig.OptimizerConfig(name, {"learning_rate": 1e-2}
                                if name != "polyak_sgd" else {}).instance
    assert len(tconfig.SCHEDULES) == 14
    for name in tconfig.SCHEDULES:
        assert callable(getattr(optax, name))


# ---------------------------------------------------------- the trainer
TRAINER_CASES = {
    "lbfgs": {"optimizer_config": {"name": "lbfgs",
                                   "kwargs": {"linesearch": None}}},
    "lamb_sgdr": {"optimizer_config": {
        "name": "lamb", "learning_rate_schedule": {
            "name": "sgdr_schedule", "kwargs": {"cosine_kwargs": [
                {"init_value": 0.0, "peak_value": 3e-3, "warmup_steps": 2,
                 "decay_steps": 4}] * 3}}}},
    "adafactor": {"width": 130, "optimizer_config": {
        "name": "adafactor", "kwargs": {"learning_rate": 1e-2}}},
}


def _train_both(monkeypatch, case, epochs=3):
    from fv3net_tpu.fit import dense as jdense

    hp = dict(input_variables=NAMES_IN, output_variables=NAMES_OUT,
              hidden_layers=2, width=16, epochs=epochs, batch_size=32,
              seed=4)
    hp.update(case)
    jb, tb = _batches(_columns())
    want = jdense.train_dense_model(jdense.DenseHyperparameters(**hp), [jb])
    _hand_over(monkeypatch, jdense.init_mlp_params(
        jax.random.PRNGKey(hp["seed"]), _sizes(hp)))
    got = tdense.train_dense_model(tdense.DenseHyperparameters(**hp), [tb])
    return got, want


@pytest.mark.parametrize("case", list(TRAINER_CASES))
def test_train_dense_model_with_tail_rules_matches_reference(
        monkeypatch, xla_decay, case):
    """n = 96, batch 32, 3 epochs, as test_train_dense_model_matches_
    reference: parameters within 1e-10 of scale (adafactor on a 130-wide
    hidden layer, so that its 130 x 130 weight is factored)."""
    got, want = _train_both(monkeypatch, TRAINER_CASES[case])
    for layer, ref in zip(got.layers, want.params):
        _assert_close([layer.weight.detach().numpy().T,
                       layer.bias.detach().numpy()],
                      [ref["w"], ref["b"]], rtol=RTOL, what=case)


def _scheduled(name):
    return {"optimizer_config": {
        "name": name, "kwargs": {}, "learning_rate_schedule": {
            "name": "constant_schedule", "kwargs": {"value": 1e-2}}}}


@pytest.mark.parametrize("case,error", [
    ({"optimizer_config": {"name": "polyak_sgd"}}, TypeError),
    ({"optimizer_config": {"name": "lbfgs"}}, TypeError),
    (_scheduled("sm3"), TypeError),
    (_scheduled("rprop"), TypeError),
    (_scheduled("optimistic_adam"), ValueError),
])
def test_configurations_optax_refuses_raise_alike(monkeypatch, case, error):
    """Where the reference's trainer or optax raises (polyak_sgd and
    lbfgs' line search need the loss, which the trainer's update does not
    pass; sm3, rprop and optimistic_adam take a float rate), the port
    raises the same class."""
    from fv3net_tpu.fit import dense as jdense

    hp = dict(input_variables=NAMES_IN, output_variables=NAMES_OUT,
              hidden_layers=1, width=4, epochs=1, batch_size=32, seed=4,
              **case)
    with pytest.raises(error):
        tdense.train_dense_model(tdense.DenseHyperparameters(**hp),
                                 [_batches(_columns())[1]])
    with pytest.raises(error):
        jdense.train_dense_model(jdense.DenseHyperparameters(**hp),
                                 [_batches(_columns())[0]])
