"""Runtime simulation parameters.

Replacement for the reference's compile-time parameter system
(``src/parameters.h:25-126`` — a struct of ``static const`` members plus
preprocessor feature flags, mirrored into GPU ``__constant__`` memory at
``src/cuda_sim.cu:52,406-408``).  Here every knob is a field of a frozen,
hashable dataclass, so a ``Params`` instance can be passed as a static
argument to ``jax.jit`` — XLA specializes the compiled program on it exactly
like the reference specialized at ``nvcc`` time, but without ``make clean``.

Feature flags (``#define RANDOM_KICK``, ``AVOID_INTRACELLULAR_THROW``,
``FULL_BOUNDARIES``, ... in parameters.h:19-77) become enum-like string
fields.  Derived quantities set in the reference ctor (parameters.h:106-122)
are ``@property``s.
"""

from __future__ import annotations

import dataclasses
import math


# Intentional-physics modes for the intracellular phase kick.
#
# The reference (RANDOM_KICK path, src/cuda_sim.cu:632) contains an operator
# precedence bug: the sign factor `(((nD-.5)>0) - ((nD-.5))<0)` parses as
# `((bool - (nD-.5)) < 0)` which is 0 for every nD in [0,1), so the
# Cauchy-distributed term is multiplied by zero and only the constant
# chemical-shift term `phase_k*1e-3*42.58*2*pi*7*tau` survives.  We support
# both the as-written behavior (for golden-curve parity) and the evidently
# intended one (symmetric heavy-tailed kick with sign(nD-0.5)).
KICK_AS_WRITTEN = "as_written"  # bug-compatible: constant chem-shift only
KICK_INTENDED = "intended"      # Cauchy kick * sign(u-1/2) + chem shift
KICK_CONSTANT = "constant"      # CONSTANT_KICK path (cuda_sim.cu:633-635)
KICK_NONE = "none"              # no intracellular kick at all

# Periodic-image handling for MNPs (src/SimulationBox.cpp:293-528).
BOUNDARY_BORDER = "border"  # duplicate MNPs within `border` of faces (default)
BOUNDARY_FULL = "full"      # all 26 images for every MNP (reference's
                            # FULL_BOUNDARIES, with its duplicated `x-bound`
                            # image bug at SimulationBox.cpp:307-308 fixed)
BOUNDARY_NONE = "none"      # no images (debug)

# Random-step direction distribution (src/cuda_sim.cu:562-586).
DIRECTION_CUBE = "cube"      # reference quirk: normalized uniform-in-cube
DIRECTION_SPHERE = "sphere"  # corrected: uniform on the unit sphere

# Field evaluation backend for the scan engine.
FIELD_EXPANSION = "expansion"  # chunked local expansion (production)
FIELD_EXACT = "exact"          # brute-force masked sum over every dipole
                               # each step — the reference's EXPLICIT mode
                               # (octree.cpp:395-396) done exactly; slow,
                               # used as an on-device oracle
FIELD_GRID = "grid"            # uniform HBM-resident field grid with exact
                               # per-voxel residents — the direct analogue
                               # of the reference's octree query
                               # (octree.cpp:151-158); positions wrap per
                               # step (cuda_sim.cu:597-601 semantics)


@dataclasses.dataclass(frozen=True)
class Params:
    """All simulation knobs.  Units follow the reference: µm, ms, T."""

    # --- Physics constants -------------------------------------------------
    #: gyromagnetic ratio in Hz/T (parameters.h:27 calls it MHz/T; the value
    #: 42.5781e6 with the 1e-3 in the phase formula makes the units work out)
    g: float = 42.5781e6
    #: compute the dipole field explicitly within scale*cell_r of a dipole
    #: (parameters.h:30, used by octree residency octree.cpp:173,241)
    scale: float = 2.0
    #: distance from the box faces within which MNPs get periodic images
    #: (parameters.h:33)
    border: float = 6.0

    # --- Scene -------------------------------------------------------------
    num_water: int = 4032          # parameters.h:46
    num_cells: int = 270           # parameters.h:49
    cell_r: float = 0.55           # cell radius, µm (parameters.h:50)
    mmoment: float = 3.5e-17       # magnetic moment per cell (parameters.h:52)
    bound: float = 30.0            # box is [0, bound]^3 µm (parameters.h:66)
    water_start_bound: float = 10.0  # initial water sub-cube (parameters.h:71)
    avoid_intracellular_throw: bool = True  # parameters.h:77
    boundary_mode: str = BOUNDARY_BORDER

    # --- Nearest-cell lookup (parameters.h:80-81) --------------------------
    hash_dim: int = 20
    max_neighbors: int = 13

    # --- Intracellular phase kick (parameters.h:54-63) ---------------------
    kick_mode: str = KICK_AS_WRITTEN
    #: st.dev of the intracellular phase accumulation (RANDOM_KICK,
    #: parameters.h:61): 2*pi*1.5e-3*42*12*10e-3
    phase_stdev: float = 2 * 3.14 * 1.5 * 1e-3 * 42 * 12 * 10e-3
    #: chemical shift in ppm under RANDOM_KICK (parameters.h:62); under
    #: KICK_CONSTANT it is the kick rate (parameters.h:59)
    phase_k: float = 5.0

    # --- Diffusion (parameters.h:84-86) ------------------------------------
    D_cell: float = 0.5547         # µm²/ms
    D_extra: float = 1.6642        # µm²/ms
    P_expr: float = 0.2            # membrane permeability, µm/ms

    # --- Membrane reflection probabilities (parameters.h:99-117) -----------
    #: The reference ctor hard-codes both to 0 (transparent membranes) and
    #: keeps the permeability formulas in comments; use
    #: :meth:`with_permeability` for the physical values.
    reflect_io: float = 0.0
    reflect_oi: float = 0.0

    # --- Background field gradient (EXTENSION; no reference analogue) -------
    #: constant background B_z gradient (gx, gy, gz) in T/µm — the
    #: applied diffusion-weighting gradient of a CPMG/PGSE-style
    #: acquisition.  Adds gx*x + gy*y + gz*z (Tesla, at the recorded
    #: post-reflection position, like the dipole field) to every phase
    #: kick; (0, 0, 0) — the default and the reference's only physics —
    #: compiles the term out entirely.  The gradient phase is
    #: moment-INDEPENDENT, so in decomposition runs it rides the B
    #: column and moment-scale reconstruction is exact.  Note the box is
    #: periodic: a walker that wraps at a chunk boundary re-enters the
    #: gradient on the other side (a sawtooth field — the only
    #: self-consistent form of a linear field in a periodic medium);
    #: with the default centered ``water_start_bound`` sub-cube wraps
    #: are travel-bound-rare over reference durations.
    b0_gradient: tuple = (0.0, 0.0, 0.0)

    # --- Time (parameters.h:88-95) -----------------------------------------
    tau: float = 1e-6              # timestep, ms (1 ns)
    totaltime: float = 40.0        # total simulated time, ms
    taucp: float = 5.5             # Carr-Purcell time, ms
    #: magnetization output interval in ms (pInt, cuda_sim.cu:44)
    print_interval: float = 1e-3

    # --- Engine knobs (no reference analogue) -------------------------------
    #: timesteps per compiled device invocation (sprint); the reference used
    #: 20000 to bound its 3.9 GB RNG/trajectory buffers (parameters.h:42,
    #: README.md:48).  Here memory is O(num_water) so this only controls
    #: host<->device round-trip granularity.  Must be a multiple of pfreq.
    sprint_steps: int = 20000
    #: steps between per-walker field-expansion rebuilds (chunk length).
    #: Must divide pfreq or be a multiple of it; see fields/local_expansion.
    chunk_steps: int = 500
    #: number of nearest dipoles kept in each walker's exact near-field
    #: list (the rest are Taylor-expanded about the chunk anchor); the
    #: scene-level validator (fields.expansion.validate_near_k) proves K
    #: covers every cell a walker can reach within a chunk
    near_k: int = 8
    #: scan-engine inner-loop unroll factor.  The lax.scan step loop pays
    #: a loop trip of device kernels per step; unrolling trades that for
    #: trace/compile time, so the default stays 1 (tests, CPU) and long
    #: scan runs (the accuracy dossier) set it explicitly.  No effect on
    #: physics.
    scan_unroll: int = 1
    #: per-axis sigma multiplier of the per-chunk travel bound (escape
    #: probability ~6*P(N>s) per walker-chunk by the reflection
    #: principle; escapes are counted by the engines).  7 -> ~8e-12 per
    #: walker-chunk; see fields.expansion.default_travel_bound
    travel_sigmas: float = 7.0
    #: Threefry rounds; must be a multiple of 4 (key injections happen
    #: every 4 rounds).  20 = crypto-grade/jax-compatible; 12 is plenty
    #: for Monte Carlo statistics and measurably faster
    rng_rounds: int = 20
    direction_mode: str = DIRECTION_CUBE
    #: scan-engine field backend (the Pallas engine always uses the
    #: expansion; FIELD_EXACT turns the scan engine into an on-device
    #: brute-force oracle)
    field_mode: str = FIELD_EXPANSION
    #: large-scene near-selection pruning (used when num_water x n_mnp is
    #: big): dipole candidates are pre-binned per spatial cube once per
    #: sprint; each cube keeps its cube_candidates nearest dipoles and
    #: walkers select near_k among those.  The runner validates that
    #: cube_candidates covers the worst-case cube (like near_k).
    cube_hash_dim: int = 16
    cube_candidates: int = 96
    #: Taylor order of the per-cube far-field tables on the large-scene
    #: path (fields/fartable.py): each cube caches a Taylor expansion of
    #: every beyond-candidate dipole's field, so a chunk rebuild touches
    #: only the ~cube_candidates nearby dipoles instead of all N — the
    #: analogue of the reference octree's cached far field
    #: (octree.cpp:262-297).  0 = disabled (exact far sums over all N
    #: every chunk).  Only consulted where a scene-level cache is
    #: precomputed (SimulationRunner / explicit build_cache callers).
    far_table_order: int = 5
    #: field-grid backend resolution (FIELD_GRID): voxels per box edge.
    #: 64 -> 0.47 µm voxels / 8 MB of corners at bound=30; accuracy scales
    #: ~h² through the trilinear far field (residents are always exact)
    grid_n: int = 64
    #: fixed resident-list width per voxel (FIELD_GRID); build_grid raises
    #: if any voxel's residency reach holds more dipoles
    grid_max_residents: int = 16

    # ----------------------------------------------------------------------
    # Derived quantities (reference ctor parameters.h:106-122 and
    # cuda_sim.cu:42-45).
    # ----------------------------------------------------------------------

    @property
    def t(self) -> int:
        """Total timesteps (parameters.h:93)."""
        return int(round(self.totaltime / self.tau))

    @property
    def tcp(self) -> int:
        """Timesteps per Carr-Purcell interval (parameters.h:95)."""
        return int(round(self.taucp / self.tau))

    @property
    def pfreq(self) -> int:
        """Steps between magnetization outputs (cuda_sim.cu:45)."""
        return int(round(self.print_interval / self.tau))

    @property
    def in_stdev(self) -> float:
        """St.dev of intracellular step length, µm (parameters.h:120)."""
        return math.sqrt(math.pi * self.D_cell * self.tau)

    @property
    def out_stdev(self) -> float:
        """St.dev of extracellular step length, µm (parameters.h:121)."""
        return math.sqrt(math.pi * self.D_extra * self.tau)

    @property
    def num_sprints(self) -> int:
        return self.t // self.sprint_steps

    @property
    def hash_cube_length(self) -> float:
        """Edge length of one nearest-cell hash cube (SimulationBox.cpp:263)."""
        return self.bound / self.hash_dim

    @property
    def phase_per_tesla(self) -> float:
        """Phase accumulated per timestep per Tesla: 2*pi*g*tau*1e-3
        (cuda_sim.cu:637)."""
        return 2.0 * math.pi * self.g * self.tau * 1e-3

    @property
    def chem_shift_kick(self) -> float:
        """The constant intracellular chemical-shift kick per step under
        RANDOM_KICK: phase_k[ppm]*1e-3*42.58*2*pi*7[T]*tau (cuda_sim.cu:632)."""
        return self.phase_k * 1e-3 * 42.58 * 2.0 * math.pi * 7.0 * self.tau

    # ----------------------------------------------------------------------
    # Construction helpers
    # ----------------------------------------------------------------------

    def reflect_pair(self, p_expr: float = None) -> tuple:
        """Map a membrane permeability (µm/ms) to the (reflect_io,
        reflect_oi) bounce probabilities via the reference's derived
        formulas (commented out in parameters.h:116-117):

            reflectIO = 1 - sqrt(tau / (6 D_cell)) * 4 * P
            reflectOI = 1 - (1 - reflectIO) * sqrt(D_cell / D_extra)

        This is THE permeability->probability mapping — the engines'
        reflect launch scalars (via :meth:`with_permeability` and manual
        engine ``reflect`` overrides), the CLI ``--sweep P`` axis,
        :func:`parallel.ensemble.run_ensemble`'s ``permeabilities``
        per-trial axis, and :func:`inverse.fit_permeability_crn` all go
        through it, so a fitted/swept P always means the same physics.
        Raises for P large enough to push reflectIO (or the derived
        reflectOI) below 0 — the formulas' own validity bounds: the
        per-step crossing probability cannot exceed 1."""
        p_val = self.P_expr if p_expr is None else float(p_expr)
        if p_val < 0:
            raise ValueError(f"permeability must be >= 0; got {p_val}")
        rio = 1.0 - math.sqrt(self.tau / (6.0 * self.D_cell)) * 4.0 * p_val
        if rio < 0.0:
            raise ValueError(
                f"permeability {p_val} µm/ms exceeds the formula's "
                f"validity bound (reflectIO < 0); max for these "
                f"tau/D_cell is "
                f"{1.0 / (math.sqrt(self.tau / (6.0 * self.D_cell)) * 4.0):g}")
        roi = 1.0 - (1.0 - rio) * math.sqrt(self.D_cell / self.D_extra)
        if roi < 0.0:
            # D_cell > D_extra amplifies the crossing probability on the
            # OI side; past this bound the derived value is no longer a
            # probability (mirror of the rio check above)
            raise ValueError(
                f"permeability {p_val} µm/ms exceeds the formula's "
                f"validity bound for D_cell/D_extra = "
                f"{self.D_cell / self.D_extra:g} (reflectOI = {roi:g} < 0)")
        return (rio, roi)

    def with_permeability(self, p_expr: float = None) -> "Params":
        """Return a copy with the physical membrane reflection probabilities
        from the commented-out reference formulas (parameters.h:116-117);
        ``p_expr`` (µm/ms) overrides the stored :attr:`P_expr`."""
        rio, roi = self.reflect_pair(p_expr)
        if p_expr is None:
            return dataclasses.replace(self, reflect_io=rio, reflect_oi=roi)
        return dataclasses.replace(self, P_expr=float(p_expr),
                                   reflect_io=rio, reflect_oi=roi)

    def impermeable(self) -> "Params":
        """Return a copy with fully impermeable membranes (parameters.h:113)."""
        return dataclasses.replace(self, reflect_io=1.0, reflect_oi=1.0)

    def replace(self, **kw) -> "Params":
        return dataclasses.replace(self, **kw)

    def scale_D(self, v: float) -> "Params":
        """The global diffusion axis: scale D_cell AND D_extra together
        by ``v`` (the semantics of the engines' d_scale launch scalar,
        the --sweep D axis, and ensemble d_scales — defined HERE once
        so validation, coverage re-checks and CSV metadata cannot
        drift apart)."""
        return self.replace(D_cell=self.D_cell * v,
                            D_extra=self.D_extra * v)

    @property
    def use_gradient(self) -> bool:
        """True when a background gradient is configured (engines gate
        the per-step term on this at trace time — zero cost when off)."""
        return any(g != 0.0 for g in self.b0_gradient)

    def validate(self) -> "Params":
        bg = self.b0_gradient
        if (not isinstance(bg, tuple) or len(bg) != 3
                or not all(isinstance(g, (int, float))
                           and math.isfinite(float(g)) for g in bg)):
            raise ValueError(
                f"b0_gradient must be a 3-tuple of finite floats "
                f"(T/µm); got {bg!r}")
        if self.sprint_steps % self.pfreq != 0:
            raise ValueError(
                f"sprint_steps ({self.sprint_steps}) must be a multiple of "
                f"pfreq ({self.pfreq})")
        if self.t % self.sprint_steps != 0:
            raise ValueError(
                f"total steps ({self.t}) must be a multiple of sprint_steps "
                f"({self.sprint_steps})")
        if self.pfreq % self.chunk_steps != 0 and self.chunk_steps % self.pfreq != 0:
            raise ValueError(
                f"chunk_steps ({self.chunk_steps}) must divide or be a "
                f"multiple of pfreq ({self.pfreq})")
        if self.kick_mode not in (KICK_AS_WRITTEN, KICK_INTENDED,
                                  KICK_CONSTANT, KICK_NONE):
            raise ValueError(f"unknown kick_mode {self.kick_mode!r}")
        for nm, v in (("reflect_io", self.reflect_io),
                      ("reflect_oi", self.reflect_oi)):
            if not (isinstance(v, (int, float)) and 0.0 <= float(v) <= 1.0):
                raise ValueError(
                    f"{nm} must be a bounce probability in [0, 1]; "
                    f"got {v!r}")
        if self.boundary_mode not in (BOUNDARY_BORDER, BOUNDARY_FULL,
                                      BOUNDARY_NONE):
            raise ValueError(f"unknown boundary_mode {self.boundary_mode!r}")
        if self.direction_mode not in (DIRECTION_CUBE, DIRECTION_SPHERE):
            raise ValueError(f"unknown direction_mode {self.direction_mode!r}")
        if self.field_mode not in (FIELD_EXPANSION, FIELD_EXACT, FIELD_GRID):
            raise ValueError(f"unknown field_mode {self.field_mode!r}")
        if self.rng_rounds % 4 != 0 or self.rng_rounds <= 0:
            raise ValueError("rng_rounds must be a positive multiple of 4")
        if self.scan_unroll < 1:
            raise ValueError("scan_unroll must be >= 1")
        if self.travel_sigmas < 3.0:
            raise ValueError(
                f"travel_sigmas={self.travel_sigmas} is unsafe: the "
                f"per-chunk escape probability ~6*P(N>s) exceeds ~1e-2 "
                f"below 3 sigma, breaking the near-list exactness "
                f"guarantee (see fields.expansion.default_travel_bound)")
        if not 0 <= self.far_table_order <= 8:
            raise ValueError(
                f"far_table_order must be in [0, 8] (0 = exact far sums); "
                f"got {self.far_table_order}")
        if self.grid_n < 2 or self.grid_max_residents < 1:
            raise ValueError("grid_n must be >= 2 and grid_max_residents "
                             ">= 1")
        if self.tcp < self.pfreq:
            # also rejects tcp == 0 (taucp ~ 0), which would reach the
            # kernels' `end_step % tcp` as an unsigned mod-by-zero
            raise ValueError(
                f"taucp ({self.taucp} ms -> tcp={self.tcp} steps) must be "
                f"at least one output interval (pfreq={self.pfreq} steps); "
                f"for no Carr-Purcell flips at all, set taucp > totaltime")
        if self.tcp % self.pfreq != 0:
            raise ValueError(
                f"taucp must align with the output interval: tcp ({self.tcp}"
                f" steps) is not a multiple of pfreq ({self.pfreq}); the "
                f"Carr-Purcell flip fires at window boundaries (the "
                f"reference had the same constraint implicitly — a "
                f"misaligned taucp silently mistimes every echo, "
                f"cuda_sim.cu:1018)")
        if not 0 < self.water_start_bound <= self.bound:
            raise ValueError("water_start_bound must be in (0, bound]")
        if not 0 < self.cell_r < self.bound:
            # a zero/negative radius otherwise fails obscurely deep in
            # scene building (rejection loops) or the residency kernels
            raise ValueError(
                f"cell_r ({self.cell_r}) must be in (0, bound)")
        return self

    def output_filename(self, timestamp: int) -> str:
        """Parameter-encoding output filename, matching the reference
        convention (src/T2_GPU_sim.cu:28-49)."""
        name = f"tau={int(self.tau * 1e9)}ps_T-e={int(2 * self.taucp)}largedipole"
        if self.boundary_mode == BOUNDARY_BORDER:
            name += f"_border={int(self.border)}um_"
        name += f"impermeablemultitrial{timestamp}"
        return name + ".csv"


#: The reference default configuration (one instance, like the global `p`
#: at cuda_sim.cu:41).
DEFAULT = Params()


def small_test_params(**overrides) -> Params:
    """A tiny configuration for fast tests: few walkers, few cells, short run.

    Keeps every code path active (kicks, flips, windows, chunk rebuilds).
    """
    base = dict(
        num_water=64,
        num_cells=12,
        bound=8.0,
        water_start_bound=6.0,
        border=3.0,
        hash_dim=8,
        totaltime=0.002,        # 2000 steps
        taucp=0.0005,           # flip every 500 steps
        print_interval=0.0001,  # window = 100 steps
        sprint_steps=1000,
        chunk_steps=100,
        near_k=6,
    )
    base.update(overrides)
    return Params(**base).validate()
