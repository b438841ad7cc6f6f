"""Inverse relaxometry: recover physical parameters from an observed
magnetization decay by differentiating THROUGH the simulator.

The scientific use of a T2 nanoparticle simulator is usually the inverse
question: given a measured decay curve, what magnetic moment (i.e. what
nanoparticle load) produced it?  The reference answers it by brute-force
forward sweeps — recompile, re-run, eyeball (README.md:13: parameters
are compile-time constants).  Here the whole simulation is a pure JAX
function, so the curve is differentiable in the physical parameters and
the inverse problem is ordinary gradient descent:

    target = simulate(scale*)            # or a measured curve
    scale  = argmin_s  mean( (simulate(s) - target)^2 )

via reverse-mode AD through every diffusion step, field evaluation,
phase kick and Carr-Purcell flip.  The counter-based RNG is integer-only
and acts as a constant of the differentiation, giving the pathwise
(reparameterized) derivative on frozen trajectories — the loss in
``scale`` is smooth and, with the same simulation seed as the target,
exactly minimized at the true value.

One device computation: the ENTIRE optimization (every Adam iteration, each
containing a full forward simulation and its backward pass) is one
`lax.scan` inside one jit — a single device computation, no host round
trips.  Each sprint of the forward pass is wrapped in `jax.checkpoint`,
so backward-pass memory is O(one sprint of state), not O(total steps):
moment recovery through a 4e7-step production run rematerializes sprints
instead of storing them.

The scan (anchor) engine is used because its XLA graph is what JAX
reverse-differentiates today; the Pallas production kernel would need a
hand-written VJP kernel.

**Production scale does not need one**: trajectories are independent of
the moment, so phase = s*A + B exactly (engine/decompose.py), and
:func:`fit_moment_scale_decomposed` fits s against a *decomposition
record* from ONE forward run of the production Pallas kernel — each
optimization step evaluates the closed form mean(cos(s*A + B)), no
backward pass through the simulator at all.  AD-through-the-simulator
(above) remains the general tool for parameters that DO bend
trajectories (cell_r, diffusion coefficients); the decomposition path is
the exact, fast answer for the moment axis specifically.
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, NamedTuple, Optional

import numpy as np

from .params import Params


class MomentFitResult(NamedTuple):
    scale: float            #: fitted moment scale (relative to params.mmoment)
    mmoment: float          #: fitted absolute moment, A*m^2... same unit as Params.mmoment
    loss: float             #: final mean-squared curve error
    scale_history: np.ndarray   #: [iters] scale per Adam iteration
    loss_history: np.ndarray    #: [iters] loss per Adam iteration


def make_curve_fn(params: Params, scene, seed: int = 0,
                  dtype=None) -> Callable:
    """Build ``curve(moment_scale) -> m[t]``: the normalized magnetization
    curve (sum cos phi / num_water, one point per output window) as a
    differentiable function of the moment scale, on a fixed scene and a
    fixed RNG seed (frozen trajectories).

    The full run is a `lax.scan` over sprints with each sprint
    `jax.checkpoint`-ed: forward cost unchanged, backward memory bounded
    by one sprint."""
    import jax
    import jax.numpy as jnp

    from . import rng
    from .engine import reference_engine as re

    dtype = dtype or jnp.float32
    p = params.validate()  # rejects t % sprint_steps != 0, among others
    sprint = re.make_sprint_fn(p, dtype)
    k = rng.key_from_seed(seed)
    key_arr = jnp.asarray([np.uint32(k[0]), np.uint32(k[1])])
    mnp_pos = jnp.asarray(np.asarray(scene.mnps[:, :3], np.float32), dtype)
    base_M = jnp.asarray(np.asarray(scene.mnps[:, 4], np.float32), dtype)
    st0 = re.init_state(scene.waters, p, dtype)
    n_sprints = p.t // p.sprint_steps

    def curve(moment_scale):
        @jax.checkpoint
        def body(st, _):
            st, wins = sprint(mnp_pos, base_M * moment_scale, key_arr,
                              st, 0)
            return st, wins[:, 0]

        _, cos = jax.lax.scan(body, st0, None, length=n_sprints)
        return cos.reshape(-1) / p.num_water

    return curve


def fit_moment_scale(target, params: Params, scene, *, seed: int = 0,
                     init_scale: float = 1.0, iters: int = 80,
                     lr: float = 0.05,
                     dtype=None) -> MomentFitResult:
    """Recover the moment scale that produced ``target`` (a normalized
    magnetization curve, one value per output window — e.g. a T2 CSV's
    sum_cos column / num_water, or a measured decay resampled onto the
    window grid).

    Adam on log(scale) (positivity by construction); the whole
    optimization runs as ONE jitted `lax.scan` over iterations.  With
    ``seed`` equal to the target's simulation seed the loss minimum is
    exactly the true scale; against independently-generated (or
    measured) data the minimum sits within the Monte-Carlo noise floor
    of the walker count."""
    import jax
    import jax.numpy as jnp
    import optax

    curve = make_curve_fn(params, scene, seed=seed, dtype=dtype)
    target = jnp.asarray(np.asarray(target, np.float32))
    n = params.t // params.pfreq
    if target.shape != (n,):
        raise ValueError(f"target must have one value per output window "
                         f"([{n}]), got {target.shape}")

    opt = optax.adam(lr)

    def loss_fn(theta):
        return jnp.mean((curve(jnp.exp(theta)) - target) ** 2)

    @jax.jit
    def run(theta0):
        def step(carry, _):
            theta, opt_state = carry
            loss, g = jax.value_and_grad(loss_fn)(theta)
            updates, opt_state = opt.update(g, opt_state)
            theta = optax.apply_updates(theta, updates)
            return (theta, opt_state), (jnp.exp(theta), loss)

        carry0 = (theta0, opt.init(theta0))
        (theta, _), (scales, losses) = jax.lax.scan(
            step, carry0, None, length=iters)
        return jnp.exp(theta), scales, losses

    scale, scales, losses = run(jnp.float32(np.log(init_scale)))
    scale = float(np.asarray(scale))
    losses = np.asarray(losses)
    return MomentFitResult(
        scale=scale,
        mmoment=scale * params.mmoment,
        loss=float(losses[-1]),
        scale_history=np.asarray(scales),
        loss_history=losses,
    )


def make_diffusion_curve_fn(params: Params, scene, seed: int = 0,
                            dtype=None) -> Callable:
    """Build ``curve(d_scale) -> m[t]``: the magnetization curve as a
    differentiable function of a global diffusion-coefficient scale
    (D_cell and D_extra both scaled by ``d_scale``), on a fixed scene
    and RNG seed.

    Unlike the moment, diffusion BENDS trajectories — phase is not
    linear in D and no decomposition shortcut exists — so this is the
    genuine differentiate-through-the-simulator path: the engine's
    ``d_scale`` launch scalar multiplies the step stdevs by
    sqrt(d_scale), the same Threefry draws act as frozen noise, and
    reverse-mode AD yields the pathwise derivative of the curve in D.

    Honesty note: the chunk-travel bound and the K-coverage certificate
    are sized for the STATIC params' stdevs.  ``d_scale`` > 1 walks
    farther per chunk and can raise the ``escapes`` / coverage-sentinel
    counters; for a D fit, set ``params.D_cell/D_extra`` to the UPPER
    end of the search bracket and fit d_scale in (0, 1] (sqrt keeps the
    loss smooth there).
    """
    import jax
    import jax.numpy as jnp

    from . import rng
    from .engine import reference_engine as re

    dtype = dtype or jnp.float32
    p = params.validate()
    sprint = re.make_sprint_fn(p, dtype)
    k = rng.key_from_seed(seed)
    key_arr = jnp.asarray([np.uint32(k[0]), np.uint32(k[1])])
    mnp_pos = jnp.asarray(np.asarray(scene.mnps[:, :3], np.float32), dtype)
    mnp_M = jnp.asarray(np.asarray(scene.mnps[:, 4], np.float32), dtype)
    st0 = re.init_state(scene.waters, p, dtype)
    n_sprints = p.t // p.sprint_steps

    def curve(d_scale):
        @jax.checkpoint
        def body(st, _):
            st, wins = sprint(mnp_pos, mnp_M, key_arr, st, 0,
                              d_scale=d_scale)
            return st, wins[:, 0]

        _, cos = jax.lax.scan(body, st0, None, length=n_sprints)
        return cos.reshape(-1) / p.num_water

    return curve


def fit_diffusion_scale(target, params: Params, scene, *, seed: int = 0,
                        init_scale: float = 1.0, iters: int = 80,
                        lr: float = 0.05,
                        dtype=None) -> MomentFitResult:
    """Recover the diffusion-coefficient scale that produced ``target``
    (ADC recovery): Adam on log(d_scale) through the full simulator —
    every displacement, membrane event, field evaluation and flip sits
    on the tape.  The reference cannot ask this question at all: D is a
    compile-time constant baked into derived stdevs (parameters.h:120).

    Returns a :class:`MomentFitResult` whose ``scale`` is the fitted
    d_scale (the ``mmoment`` field is nan — not a moment fit).
    """
    import jax
    import jax.numpy as jnp
    import optax

    curve = make_diffusion_curve_fn(params, scene, seed=seed, dtype=dtype)
    target = jnp.asarray(np.asarray(target, np.float32))
    n = params.t // params.pfreq
    if target.shape != (n,):
        raise ValueError(f"target must have one value per output window "
                         f"([{n}]), got {target.shape}")

    opt = optax.adam(lr)

    def loss_fn(theta):
        return jnp.mean((curve(jnp.exp(theta)) - target) ** 2)

    @jax.jit
    def run(theta0):
        def step(carry, _):
            theta, opt_state = carry
            loss, g = jax.value_and_grad(loss_fn)(theta)
            updates, opt_state = opt.update(g, opt_state)
            theta = optax.apply_updates(theta, updates)
            return (theta, opt_state), (jnp.exp(theta), loss)

        (theta, _), (scales, losses) = jax.lax.scan(
            step, (theta0, opt.init(theta0)), None, length=iters)
        return jnp.exp(theta), scales, losses

    scale, scales, losses = run(jnp.float32(np.log(init_scale)))
    scale = float(np.asarray(scale))
    losses = np.asarray(losses)
    return MomentFitResult(
        scale=scale,
        mmoment=float("nan"),
        loss=float(losses[-1]),
        scale_history=np.asarray(scales),
        loss_history=losses,
    )


def make_engine_curve_fn(params: Params, scene, seed: int = 0,
                         engine: str = "pallas",
                         rng_impl: str = "threefry",
                         interpret: bool = False, dtype=None) -> Callable:
    """Build ``curve(d_scale=1.0, *, m_scale=1.0, cell_r=None) -> m[t]``
    on the PRODUCTION engine (or the scan engine): a plain forward
    evaluation at concrete physical-parameter values — not
    differentiable through Pallas, but every call shares one compiled
    program (``d_scale``/``cell_r`` are the kernel's launch scalars;
    ``m_scale`` multiplies the traced ``mnp_M`` array), and the
    Threefry streams depend only on (seed, step), so all
    evaluations see identical random draws (common random numbers).

    ``cell_r`` overrides the residency radius on the FIXED scene (same
    cell centers, different radius); the caller owns the coverage
    argument for radii above the params value (see
    :func:`fit_cell_radius_crn`, which validates the bracket top).

    ``p_expr`` (µm/ms) overrides the membrane permeability through
    :meth:`Params.reflect_pair` and the engines' reflect launch scalars;
    it requires reflection enabled in the STATIC params (e.g.
    ``params.with_permeability()`` — :func:`fit_permeability_crn`
    promotes its params automatically)."""
    import jax.numpy as jnp

    from . import rng
    from .engine import pallas_engine as pe
    from .engine import reference_engine as re

    dtype = dtype or jnp.float32
    p = params.validate()
    k = rng.key_from_seed(seed)
    key_arr = jnp.asarray([np.uint32(k[0]), np.uint32(k[1])])
    mnp_pos = jnp.asarray(np.asarray(scene.mnps[:, :3], np.float32), dtype)
    mnp_M = jnp.asarray(np.asarray(scene.mnps[:, 4], np.float32), dtype)
    n_sprints = p.t // p.sprint_steps
    if engine == "pallas":
        sprint = pe.make_sprint_fn(p, scene.waters.shape[0], dtype,
                                   rng_impl, interpret)
        st0 = pe.to_planes(re.init_state(scene.waters, p, dtype), p)
    elif engine == "scan":
        sprint = re.make_sprint_fn(p, dtype)
        st0 = re.init_state(scene.waters, p, dtype)
    else:
        raise ValueError(f"unknown engine {engine!r}")

    def curve(d_scale: float = 1.0, *, m_scale: float = 1.0,
              cell_r: Optional[float] = None,
              p_expr: Optional[float] = None) -> np.ndarray:
        mM = mnp_M if m_scale == 1.0 else mnp_M * dtype(m_scale)
        cr = None if cell_r is None else dtype(cell_r)
        rf = None if p_expr is None else p.reflect_pair(float(p_expr))
        st = st0
        outs = []
        for _ in range(n_sprints):
            st, wins = sprint(mnp_pos, mM, key_arr, st, 0,
                              cell_r=cr, d_scale=float(d_scale),
                              reflect=rf)
            outs.append(np.asarray(wins)[:, 0])
        return np.concatenate(outs) / p.num_water

    return curve


def fit_diffusion_scale_crn(target, params: Params, scene, *,
                            seed: int = 0,
                            bracket: tuple = (0.05, 1.0),
                            iters: int = 20, engine: str = "pallas",
                            rng_impl: str = "threefry",
                            interpret: bool = False,
                            dtype=None) -> MomentFitResult:
    """ADC recovery at PRODUCTION scale: golden-section search for the
    diffusion scale minimizing the curve MSE, each evaluation a full
    forward run of the production Pallas kernel at a runtime ``d_scale``
    (one compiled program for the whole fit — the launch scalar).

    Derivative-free by design: reverse-mode AD does not reach through a
    Pallas kernel, but common random numbers (counter RNG keyed only by
    (seed, step)) make the loss a deterministic, noise-free function of
    d_scale, so a ~20-evaluation bracket search resolves the minimum to
    ~1e-3 relative — each evaluation at the kernel's full speed.
    The search runs on log(d) (scale parameters live on
    a ratio scale).

    The same coverage honesty note as :func:`fit_diffusion_scale`
    applies: size ``params.D_cell/D_extra`` to the TOP of the search
    bracket and keep ``bracket[1] <= 1`` so the K-coverage certificate
    holds at every probed scale.

    Returns a :class:`MomentFitResult`: ``scale`` is the fitted d_scale,
    ``scale_history``/``loss_history`` record every probed point in
    evaluation order (``mmoment`` is nan — not a moment fit)."""
    lo, hi = float(bracket[0]), float(bracket[1])
    if not (0 < lo < hi):
        raise ValueError(f"bracket must satisfy 0 < lo < hi; got {bracket}")
    target = np.asarray(target, np.float64)
    n = params.t // params.pfreq
    if target.shape != (n,):
        raise ValueError(f"target must have one value per output window "
                         f"([{n}]), got {target.shape}")
    curve = make_engine_curve_fn(params, scene, seed=seed, engine=engine,
                                 rng_impl=rng_impl, interpret=interpret,
                                 dtype=dtype)

    hist_d, hist_l = [], []

    def loss(logd):
        d = float(np.exp(logd))
        val = float(np.mean((np.asarray(curve(d), np.float64)
                             - target) ** 2))
        hist_d.append(d)
        hist_l.append(val)
        return val

    # golden-section on log d: unimodal within a sane bracket (the MSE
    # of a monotone-in-D decay family against one of its members)
    _golden_log_search(loss, lo, hi, iters)
    best = int(np.argmin(hist_l))
    return MomentFitResult(
        scale=float(hist_d[best]),
        mmoment=float("nan"),
        loss=float(hist_l[best]),
        scale_history=np.asarray(hist_d),
        loss_history=np.asarray(hist_l),
    )


def _golden_log_search(loss, lo: float, hi: float, iters: int) -> None:
    """Golden-section minimization of ``loss(log_x)`` over
    ``[log lo, log hi]`` with ``iters`` total evaluations (scale
    parameters live on a ratio scale, so the search runs on logs).
    History/result capture belongs to the ``loss`` closure."""
    invphi = (np.sqrt(5.0) - 1.0) / 2.0
    a, b = np.log(lo), np.log(hi)
    c, d_ = b - invphi * (b - a), a + invphi * (b - a)
    fc, fd = loss(c), loss(d_)
    for _ in range(max(0, iters - 2)):
        if fc < fd:
            b, d_, fd = d_, c, fc
            c = b - invphi * (b - a)
            fc = loss(c)
        else:
            a, c, fc = c, d_, fd
            d_ = a + invphi * (b - a)
            fd = loss(d_)


def fit_cell_radius_crn(target, params: Params, scene, *,
                        seed: int = 0,
                        bracket: tuple = (0.3, 1.0),
                        iters: int = 20, engine: str = "pallas",
                        rng_impl: str = "threefry",
                        interpret: bool = False,
                        dtype=None) -> MomentFitResult:
    """Cell-size recovery at PRODUCTION scale: golden-section search for
    the cell radius (um) minimizing the curve MSE on a FIXED scene —
    same cell centers and walkers, the radius entering only through the
    kernel's cell_r launch scalar (residency, field mask, membrane
    events and kick gating), so every evaluation shares ONE compiled
    program and common random numbers.  The microstructure question:
    what cell size produced this decay?

    Like the D axis, cell_r BENDS trajectories (no decomposition
    shortcut exists), and like :func:`fit_diffusion_scale_crn` the
    counter RNG makes the loss a deterministic, noise-free function of
    the radius, so ~20 bracketed evaluations resolve it.

    Coverage honesty: the near-list reach is ``cell_r + travel`` and
    grows monotonically with cell_r, so the covering-lattice certificate
    is checked ONCE here at the bracket TOP — every probed radius below
    it is then covered.  Brackets above the scene's validated radius
    raise before any kernel runs.

    Returns a :class:`MomentFitResult` with ``scale`` = fitted cell_r in
    um (``mmoment`` is nan — not a moment fit)."""
    lo, hi = float(bracket[0]), float(bracket[1])
    if not (0 < lo < hi):
        raise ValueError(f"bracket must satisfy 0 < lo < hi; got {bracket}")
    p_hi = params.replace(cell_r=hi).validate()
    from .fields import expansion
    worst = expansion.validate_near_k(scene.mnps[:, :3], p_hi)
    if worst > params.near_k:
        raise ValueError(
            f"bracket top cell_r={hi} needs near_k >= {worst} on this "
            f"scene (configured {params.near_k}); raise near_k or lower "
            f"the bracket")
    target = np.asarray(target, np.float64)
    n = params.t // params.pfreq
    if target.shape != (n,):
        raise ValueError(f"target must have one value per output window "
                         f"([{n}]), got {target.shape}")
    curve = make_engine_curve_fn(params, scene, seed=seed, engine=engine,
                                 rng_impl=rng_impl, interpret=interpret,
                                 dtype=dtype)

    hist_r, hist_l = [], []

    def loss(logr):
        r = float(np.exp(logr))
        val = float(np.mean((np.asarray(curve(cell_r=r), np.float64)
                             - target) ** 2))
        hist_r.append(r)
        hist_l.append(val)
        return val

    _golden_log_search(loss, lo, hi, iters)
    best = int(np.argmin(hist_l))
    return MomentFitResult(
        scale=float(hist_r[best]),
        mmoment=float("nan"),
        loss=float(hist_l[best]),
        scale_history=np.asarray(hist_r),
        loss_history=np.asarray(hist_l),
    )


def fit_permeability_crn(target, params: Params, scene, *,
                         seed: int = 0,
                         bracket: tuple = (0.1, 100.0),
                         iters: int = 20, engine: str = "pallas",
                         rng_impl: str = "threefry",
                         interpret: bool = False,
                         dtype=None) -> MomentFitResult:
    """Membrane-permeability recovery at PRODUCTION scale: golden-section
    search for the permeability P (µm/ms) minimizing the curve MSE, each
    probe mapped to (reflect_io, reflect_oi) bounce probabilities via
    :meth:`Params.reflect_pair` (the commented-out parameters.h:116-117
    formulas) and fed to the kernel as reflect launch scalars — one
    compiled program for the whole fit, common random numbers across
    probes (the coin stream is identical at every P; only the comparison
    thresholds move, so the loss is a deterministic step-free function
    of P wherever no coin changes side, and the bracket search is
    noise-free in the CRN sense of the other fits).

    The search runs on log(P).  The bracket top is validated against the
    formulas' bound up front (reflectIO must stay >= 0); reflection is
    traced into the engine automatically when ``params`` ships it
    disabled (the reference's default, parameters.h:116-117).

    Returns a :class:`MomentFitResult` with ``scale`` = fitted P in
    µm/ms (``mmoment`` is nan — not a moment fit)."""
    lo, hi = float(bracket[0]), float(bracket[1])
    if not (0 < lo < hi):
        raise ValueError(f"bracket must satisfy 0 < lo < hi; got {bracket}")
    params.reflect_pair(hi)     # raises past the formula's validity bound
    if not (params.reflect_io > 0 or params.reflect_oi > 0):
        params = params.with_permeability()
    target = np.asarray(target, np.float64)
    n = params.t // params.pfreq
    if target.shape != (n,):
        raise ValueError(f"target must have one value per output window "
                         f"([{n}]), got {target.shape}")
    curve = make_engine_curve_fn(params, scene, seed=seed, engine=engine,
                                 rng_impl=rng_impl, interpret=interpret,
                                 dtype=dtype)

    hist_p, hist_l = [], []

    def loss(logp):
        pv = float(np.exp(logp))
        val = float(np.mean((np.asarray(curve(p_expr=pv), np.float64)
                             - target) ** 2))
        hist_p.append(pv)
        hist_l.append(val)
        return val

    _golden_log_search(loss, lo, hi, iters)
    best = int(np.argmin(hist_l))
    return MomentFitResult(
        scale=float(hist_p[best]),
        mmoment=float("nan"),
        loss=float(hist_l[best]),
        scale_history=np.asarray(hist_p),
        loss_history=np.asarray(hist_l),
    )


class JointFitResult(NamedTuple):
    m_scale: float          #: fitted moment scale (relative to params.mmoment)
    d_scale: float          #: fitted diffusion-coefficient scale
    mmoment: float          #: fitted absolute moment (m_scale * params.mmoment)
    loss: float             #: best mean-squared curve error
    m_history: np.ndarray   #: [n_evals] probed moment scales
    d_history: np.ndarray   #: [n_evals] probed diffusion scales
    loss_history: np.ndarray  #: [n_evals] loss per evaluation


def _nelder_mead(loss, x0: np.ndarray, step: np.ndarray,
                 max_evals: int, xtol: float = 1e-4) -> None:
    """Minimal deterministic Nelder-Mead on ``loss(x)`` (x: [n]).
    Standard reflect/expand/contract/shrink coefficients; stops at
    ``max_evals`` evaluations or simplex diameter < ``xtol``.  History
    and best-point capture belong to the ``loss`` closure (which also
    enforces bounds by returning +inf outside them)."""
    n = x0.size
    evals = [0]

    def f(x):
        evals[0] += 1
        return loss(x)

    simplex = [np.asarray(x0, np.float64)]
    for i in range(n):
        v = np.asarray(x0, np.float64).copy()
        v[i] += step[i]
        simplex.append(v)
    vals = [f(v) for v in simplex]
    while evals[0] < max_evals:
        order = np.argsort(vals)
        simplex = [simplex[i] for i in order]
        vals = [vals[i] for i in order]
        if max(np.max(np.abs(v - simplex[0])) for v in simplex[1:]) < xtol:
            break
        centroid = np.mean(simplex[:-1], axis=0)
        xr = centroid + (centroid - simplex[-1])        # reflection
        fr = f(xr)
        if fr < vals[0]:
            xe = centroid + 2.0 * (centroid - simplex[-1])  # expansion
            fe = f(xe)
            simplex[-1], vals[-1] = (xe, fe) if fe < fr else (xr, fr)
        elif fr < vals[-2]:
            simplex[-1], vals[-1] = xr, fr
        else:
            xc = centroid + 0.5 * (simplex[-1] - centroid)  # contraction
            fc = f(xc)
            if fc < vals[-1]:
                simplex[-1], vals[-1] = xc, fc
            else:                                       # shrink toward best
                for i in range(1, n + 1):
                    simplex[i] = simplex[0] + 0.5 * (simplex[i] - simplex[0])
                    vals[i] = f(simplex[i])


def fit_joint_crn(target, params: Params, scene, *, seed: int = 0,
                  m_bracket: tuple = (0.25, 4.0),
                  d_bracket: tuple = (0.05, 1.0),
                  max_evals: int = 80, engine: str = "pallas",
                  rng_impl: str = "threefry", interpret: bool = False,
                  dtype=None) -> JointFitResult:
    """JOINT recovery of (moment scale, diffusion scale) from one
    observed decay — the real measured-data problem, where neither the
    nanoparticle load nor the tissue ADC is known a priori, and the two
    axes are entangled (both deepen the decay; they separate through the
    echo-shape/motional-narrowing signature).

    Derivative-free Nelder-Mead on (log s, log d): each evaluation is a
    full forward run of the production Pallas kernel with the moment
    entering through the traced ``mnp_M`` array and the diffusion scale
    through the d_scale launch scalar — ONE compiled program for the
    entire fit, and common random numbers (counter RNG keyed by
    (seed, step)) make the 2D loss a deterministic surface with its
    minimum exactly at the truth when the target shares the seed.
    Probes outside the brackets cost +inf (never simulated), which also
    keeps every probed d inside the coverage-certified (0, d_hi] range
    (size params' D to the bracket top, as with
    :func:`fit_diffusion_scale_crn`).

    ~60-80 evaluations resolve both scales to <1% at test scale; at full
    reference scale each evaluation is one full production run.

    The alternative decomposition-record profile fit (closed-form s per
    probed d) costs a per-walker record drain per evaluation — cheaper
    only when the record is being produced anyway; this direct search is
    the production path."""
    m_lo, m_hi = float(m_bracket[0]), float(m_bracket[1])
    d_lo, d_hi = float(d_bracket[0]), float(d_bracket[1])
    for name, (lo, hi) in (("m_bracket", (m_lo, m_hi)),
                           ("d_bracket", (d_lo, d_hi))):
        if not (0 < lo < hi):
            raise ValueError(f"{name} must satisfy 0 < lo < hi; "
                             f"got {(lo, hi)}")
    target = np.asarray(target, np.float64)
    n = params.t // params.pfreq
    if target.shape != (n,):
        raise ValueError(f"target must have one value per output window "
                         f"([{n}]), got {target.shape}")
    curve = make_engine_curve_fn(params, scene, seed=seed, engine=engine,
                                 rng_impl=rng_impl, interpret=interpret,
                                 dtype=dtype)

    hist_m, hist_d, hist_l = [], [], []

    def loss(x):
        s, d = float(np.exp(x[0])), float(np.exp(x[1]))
        if not (m_lo <= s <= m_hi and d_lo <= d <= d_hi):
            return float("inf")
        val = float(np.mean(
            (np.asarray(curve(d, m_scale=s), np.float64) - target) ** 2))
        hist_m.append(s)
        hist_d.append(d)
        hist_l.append(val)
        return val

    x0 = np.array([np.log(m_lo * m_hi) / 2.0, np.log(d_lo * d_hi) / 2.0])
    step = np.array([np.log(m_hi / m_lo) / 4.0, np.log(d_hi / d_lo) / 4.0])
    _nelder_mead(loss, x0, step, max_evals)
    if not hist_l:
        raise RuntimeError("no in-bracket evaluation happened; check the "
                           "brackets")
    best = int(np.argmin(hist_l))
    return JointFitResult(
        m_scale=float(hist_m[best]),
        d_scale=float(hist_d[best]),
        mmoment=float(hist_m[best]) * params.mmoment,
        loss=float(hist_l[best]),
        m_history=np.asarray(hist_m),
        d_history=np.asarray(hist_d),
        loss_history=np.asarray(hist_l),
    )


def fit_moment_scale_decomposed(target, A, B, *, mmoment: float = None,
                                init_scale: float = 1.0, iters: int = 200,
                                lr: float = 0.1) -> MomentFitResult:
    """Recover the moment scale from a phase-decomposition record
    (engine/decompose.run_decomposition): minimizes
    ``mean((mean_i cos(s*A + B) - target)^2)`` over s by Adam on log(s).

    Exact at any scale (phase = s*A + B is physics, not a model), and
    each iteration is one elementwise pass over (A, B) — no simulation,
    no backward pass through the simulator — so it runs at production
    scale against a record produced by the Pallas kernel.

    ``mmoment``: the base moment the record was produced with; fills the
    result's absolute-moment field (nan if omitted).
    """
    import jax
    import jax.numpy as jnp
    import optax

    A = jnp.asarray(np.asarray(A, np.float32))
    B = jnp.asarray(np.asarray(B, np.float32))
    target = jnp.asarray(np.asarray(target, np.float32))
    if target.shape != (A.shape[0],):
        raise ValueError(f"target must have one value per window "
                         f"([{A.shape[0]}]), got {target.shape}")
    if not init_scale > 0:
        raise ValueError("init_scale must be > 0")

    opt = optax.adam(lr)

    def loss_fn(theta):
        rec = jnp.mean(jnp.cos(jnp.exp(theta) * A + B), axis=-1)
        return jnp.mean((rec - target) ** 2)

    @jax.jit
    def run(theta0):
        def step(carry, _):
            theta, opt_state = carry
            loss, g = jax.value_and_grad(loss_fn)(theta)
            updates, opt_state = opt.update(g, opt_state)
            theta = optax.apply_updates(theta, updates)
            return (theta, opt_state), (jnp.exp(theta), loss)

        (theta, _), (scales, losses) = jax.lax.scan(
            step, (theta0, opt.init(theta0)), None, length=iters)
        return jnp.exp(theta), scales, losses

    scale, scales, losses = run(jnp.float32(np.log(init_scale)))
    scale = float(np.asarray(scale))
    losses = np.asarray(losses)
    return MomentFitResult(
        scale=scale,
        mmoment=scale * mmoment if mmoment is not None else float("nan"),
        loss=float(losses[-1]),
        scale_history=np.asarray(scales),
        loss_history=losses,
    )


def fit_from_record(record_path: str, target_csv: str, *,
                    init_scale: float = 1.0, iters: int = 200,
                    lr: float = 0.1) -> MomentFitResult:
    """Closed-form moment recovery from SAVED artifacts: a
    decomposition record (``mri-t2-sim --dump-record``) and an observed
    decay curve (reference CSV schema).  The measured workflow: simulate
    the basis once at production speed, then fit any number of measured
    curves offline — no simulator in the loop.

    The target's sum_cos column is normalized by the record's walker
    count; its rows must cover at least the record's windows (extra
    tail rows are ignored; times are trusted to align — both sides are
    window-gridded by construction).  ``record_path`` may be a
    ``--dump-record`` .npz or a ``--record-dir`` store directory."""
    from .engine.decompose import open_record
    from .io.writer import read_t2_csv

    A, B, meta = open_record(record_path)
    times = meta["times_ms"]
    mmoment = meta["mmoment"]
    cols = read_t2_csv(target_csv)
    n, w = A.shape
    if len(cols[0]) < n:
        raise ValueError(
            f"target has {len(cols[0])} rows but the record holds {n} "
            f"windows; the measured curve must cover the record")
    if times is not None and not np.allclose(cols[0][:n], times,
                                             rtol=1e-9, atol=1e-9):
        raise ValueError(
            f"target time axis does not match the record's windows "
            f"(target starts {cols[0][:3]}, record {times[:3]} ms); "
            f"resample the measurement onto the record's output grid")
    target = np.asarray(cols[1][:n], np.float64) / w
    if np.max(np.abs(target)) > 1.0 + 1e-3:
        raise ValueError(
            f"normalized target reaches {np.max(np.abs(target)):.3g} "
            f"(> 1): the CSV's sums were not produced by the record's "
            f"{w} walkers — check the measurement's walker count")
    return fit_moment_scale_decomposed(
        target, A, B, mmoment=mmoment, init_scale=init_scale,
        iters=iters, lr=lr)


def main(argv=None) -> int:
    """CLI demo: ``mri-t2-invert`` — simulate a target curve at a hidden
    moment scale, then recover it by gradient descent from 1.0."""
    from .params import small_test_params
    from .scene import BacteriaBox

    ap = argparse.ArgumentParser(
        description="Recover the nanoparticle moment from a decay curve "
                    "by differentiating through the simulator")
    ap.add_argument("--true-scale", type=float, default=1.4,
                    help="hidden moment scale that generates the target")
    ap.add_argument("--init-scale", type=float, default=1.0)
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--num-water", type=int, default=256)
    ap.add_argument("--scene-seed", type=int, default=1)
    ap.add_argument("--seed", type=int, default=2,
                    help="simulation RNG seed (shared by target and fit)")
    ap.add_argument("--method", choices=["ad", "decompose", "crn"],
                    default="ad",
                    help="'ad': reverse-mode AD through the simulator "
                         "(general); 'decompose': one forward "
                         "phase-decomposition run + closed-form fit "
                         "(exact for the moment axis, production-fast); "
                         "'crn': derivative-free golden-section with "
                         "common random numbers on the production "
                         "Pallas kernel (the production path for the "
                         "D axis)")
    ap.add_argument("--axis", choices=["moment", "D", "cell_r", "joint"],
                    default="moment",
                    help="which physical parameter to recover: the "
                         "nanoparticle moment (default), the global "
                         "diffusion-coefficient scale (ADC), the cell "
                         "radius (um, CRN bracket search on a fixed "
                         "scene), or 'joint' — moment AND diffusion "
                         "scale together by CRN Nelder-Mead (the "
                         "measured-data problem; --true-scale sets the "
                         "hidden moment scale, the hidden d_scale is "
                         "fixed at 0.6)")
    ap.add_argument("--record", default=None, metavar="PATH",
                    help="fit against a SAVED decomposition record "
                         "(mri-t2-sim --dump-record .npz or "
                         "--record-dir store directory): closed-form "
                         "moment recovery from real data — pass the "
                         "measured curve via --target")
    ap.add_argument("--target", default=None, metavar="CSV",
                    help="with --record: the observed decay curve "
                         "(reference CSV schema time_ms,sum_cos; "
                         "normalized by the record's walker count)")
    args = ap.parse_args(argv)
    if (args.record is None) != (args.target is None):
        ap.error("--record and --target go together (record = the "
                 "simulation basis, target = the measured curve)")
    if args.record:
        if args.axis != "moment" or args.method == "crn":
            ap.error("--record is the moment axis's closed-form basis "
                     "(phase = s*A + B); D fits need fresh simulation")
        if not args.init_scale > 0:
            ap.error("scales must be > 0")
        fit = fit_from_record(args.record, args.target,
                              init_scale=args.init_scale,
                              iters=args.iters, lr=args.lr)
        print(f"recovered moment scale = {fit.scale:.5f} "
              f"(absolute moment {fit.mmoment:.4e}), "
              f"loss {fit.loss:.3e}")
        return 0
    if not args.true_scale > 0 or not args.init_scale > 0:
        ap.error("scales must be > 0")
    if args.axis == "D":
        if args.method == "decompose":
            ap.error("no decomposition shortcut exists for the D axis "
                     "(diffusion BENDS trajectories); use 'ad' or 'crn'")
        if not args.true_scale <= 1.0:
            ap.error("--axis D fits within the certified bracket "
                     "(0, 1]: size the params' D to the bracket top "
                     "(see inverse.make_diffusion_curve_fn)")
    elif args.axis in ("cell_r", "joint"):
        if args.method != "crn":
            ap.error(f"--axis {args.axis} is a CRN bracket search "
                     f"(cell_r enters through booleans — not usefully "
                     f"differentiable; joint fits are 2D); use "
                     f"--method crn")
        if args.axis == "cell_r" and not 0.3 <= args.true_scale <= 1.0:
            ap.error("--axis cell_r demo searches radii in "
                     "[0.3, 1.0] um; pick --true-scale inside it")
    elif args.method == "crn":
        ap.error("'crn' searches the launch scalars; use it with "
                 "--axis D, cell_r or joint (the moment axis has the "
                 "exact 'decompose' shortcut instead)")

    # ~20x the tiny-test moment: deep intra-window dephasing gives the
    # fit a strong signal (at 3.5e-15 the curve barely decays)
    p = small_test_params(num_water=args.num_water,
                          mmoment=2e-14 if args.axis == "moment" else 5e-14)
    sc = BacteriaBox(p, seed=args.scene_seed).populate()
    if args.method == "crn":
        # production engine on a GPU; the scan engine elsewhere (the
        # demo must run anywhere).  The TARGET comes from the SAME engine
        # as the fit: the engines fold sqrt(d_scale) in different
        # multiply orders, so a cross-engine target at a non-power-of-two
        # scale would put a trajectory-divergence noise floor under the
        # CRN loss — exactly the premise ('deterministic, zero at truth')
        # the fit rests on.
        import jax
        from .engine.pallas_engine import choose_engine
        eng = choose_engine(anywhere=True)
        print(f"crn demo: {eng} engine on "
              f"{jax.devices()[0].platform}", file=sys.stderr)
        if args.axis == "cell_r":
            # size the static near list for the bracket top so the
            # coverage certificate holds at every probed radius
            from .fields import expansion
            worst = expansion.validate_near_k(
                sc.mnps[:, :3], p.replace(cell_r=1.0))
            if worst > p.near_k:
                p = p.replace(near_k=worst)
        curve = make_engine_curve_fn(p, sc, seed=args.seed, engine=eng)
    elif args.axis == "D":
        curve = make_diffusion_curve_fn(p, sc, seed=args.seed)
    else:
        curve = make_curve_fn(p, sc, seed=args.seed)
    hidden_d = 0.6          # the joint demo's second hidden parameter
    if args.axis == "joint":
        target = np.asarray(curve(hidden_d, m_scale=args.true_scale))
    elif args.axis == "cell_r":
        target = np.asarray(curve(cell_r=args.true_scale))
    else:
        target = np.asarray(curve(args.true_scale))
    print(f"target: {len(target)} windows, final m = {target[-1]:.4f} "
          f"(hidden {args.axis} scale {args.true_scale})")
    if args.method == "decompose":
        from .engine.decompose import run_decomposition
        rec = run_decomposition(sc, p, seed=args.seed, engine="scan")
        fit = fit_moment_scale_decomposed(
            target, rec.A, rec.B, mmoment=p.mmoment,
            init_scale=args.init_scale, iters=args.iters, lr=args.lr)
    elif args.method == "crn" and args.axis == "joint":
        jfit = fit_joint_crn(target, p, sc, seed=args.seed,
                             max_evals=args.iters, engine=eng)
        err = max(abs(jfit.m_scale - args.true_scale) / args.true_scale,
                  abs(jfit.d_scale - hidden_d) / hidden_d)
        print(f"recovered (moment, D) scales = ({jfit.m_scale:.5f}, "
              f"{jfit.d_scale:.5f}) (true ({args.true_scale}, "
              f"{hidden_d}), worst rel err {err:.2e}), "
              f"loss {jfit.loss:.3e} after {len(jfit.loss_history)} "
              f"evaluations")
        return 0 if err < 0.05 else 1
    elif args.method == "crn" and args.axis == "cell_r":
        fit = fit_cell_radius_crn(target, p, sc, seed=args.seed,
                                  bracket=(0.3, 1.0), iters=args.iters,
                                  engine=eng)
    elif args.method == "crn":
        # bracket straddles the hidden truth: lo never above half of it
        # (a truth below a fixed lo would silently converge to the
        # bracket edge), hi at the certified 1.0
        lo = min(max(0.05, args.true_scale / 5), args.true_scale / 2)
        fit = fit_diffusion_scale_crn(
            target, p, sc, seed=args.seed, bracket=(lo, 1.0),
            iters=args.iters, engine=eng)
    elif args.axis == "D":
        fit = fit_diffusion_scale(target, p, sc, seed=args.seed,
                                  init_scale=args.init_scale,
                                  iters=args.iters, lr=args.lr)
    else:
        fit = fit_moment_scale(target, p, sc, seed=args.seed,
                               init_scale=args.init_scale, iters=args.iters,
                               lr=args.lr)
    err = abs(fit.scale - args.true_scale) / args.true_scale
    print(f"recovered scale = {fit.scale:.5f} "
          f"(true {args.true_scale}, rel err {err:.2e}), "
          f"loss {fit.loss:.3e} after {args.iters} {args.method} iterations")
    return 0 if err < 0.05 else 1


if __name__ == "__main__":
    sys.exit(main())
