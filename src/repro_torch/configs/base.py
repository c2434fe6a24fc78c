"""Config dataclasses of the port: the language models it serves, the
hydro scenarios and the aggregation knobs the port runs.

``ModelConfig``, ``HydroConfig``, ``AMRHydroConfig`` and
``GravityHydroConfig`` are the reference's as they are.
``AggregationConfig`` keeps the fields the port reads, and an invalid
value raises ``ValueError``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Mapping, Optional, Tuple


# ---------------------------------------------------------------------------
# Model configs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | encdec | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    qkv_bias: bool = False
    sliding_window: int = 0           # 0 -> full attention; >0 -> SWA
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    shared_expert_d_ff: int = 0       # qwen2-moe shared expert width
    # --- SSM / xLSTM / Mamba2 ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_chunk: int = 256
    slstm_every: int = 0
    # --- hybrid (zamba2) ---
    shared_attn_every: int = 0
    # --- enc-dec ---
    n_encoder_layers: int = 0
    encoder_seq_ratio: int = 1
    # --- vlm ---
    cross_attn_every: int = 0
    vision_tokens: int = 0
    mlp_gated: bool = True            # SwiGLU (3 mats) vs plain MLP (2 mats)
    # --- numerics ---
    dtype: str = "bfloat16"
    remat: bool = True

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self, active_only: bool = False) -> int:
        """Approximate parameter count; active_only counts routed experts
        at top_k/n_experts utilisation (MoE active params)."""
        d, h = self.d_model, self.resolved_head_dim
        nq, nkv = self.n_heads, self.n_kv_heads
        attn = d * (nq * h) + 2 * d * (nkv * h) + (nq * h) * d
        n_ff_mats = 3 if self.mlp_gated else 2
        if self.family in ("ssm", "hybrid"):
            inner = self.ssm_expand * d
            mixer = (d * (2 * inner + 2 * self.ssm_state + self.n_heads)
                     + inner * d)
        else:
            mixer = attn
        if self.n_experts:
            ff_one = n_ff_mats * d * self.d_ff
            routed = self.n_experts * ff_one
            if active_only:
                routed = self.top_k * ff_one
            shared = (self.n_shared_experts * n_ff_mats * d
                      * (self.shared_expert_d_ff or self.d_ff))
            ff = routed + shared + d * self.n_experts       # router
        elif self.d_ff:
            ff = n_ff_mats * d * self.d_ff
        else:
            ff = 0
        if self.shared_attn_every:
            total = self.n_layers * (mixer + 2 * d) + (attn + ff + 2 * d)
        else:
            total = self.n_layers * (mixer + ff + 2 * d)
        if self.n_encoder_layers:
            total += self.n_encoder_layers * (attn + ff + 2 * d)
        total += self.vocab_size * d * (1 if self.tie_embeddings else 2)
        return int(total)


# ---------------------------------------------------------------------------
# Shape cells
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str                 # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeConfig("train_4k", "train", 4_096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524_288, 1)

ALL_SHAPES: Tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K,
                                       LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def shape_applicable(cfg: ModelConfig,
                     shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether a shape cell applies to an architecture: ``long_500k`` only
    for sub-quadratic ones (ssm, hybrid, or a sliding window)."""
    if shape.name == "long_500k":
        sub_quadratic = (cfg.family in ("ssm", "hybrid")
                         or cfg.sliding_window > 0)
        if not sub_quadratic:
            return False, ("pure full-attention arch: 500k dense-KV decode "
                           "excluded per spec")
    return True, ""


# the launch strategies the port registers (the reference's set)
PORTED_STRATEGIES = ("fused", "s2", "s3", "s2+s3", "mixed", "s4", "sharded")
STAGING_MODES = ("device", "host")
FLUSH_POLICIES = ("eager", "watermark", "cost")
GUARD_MODES = ("off", "finite")
PRIOR_MODES = ("off", "roofline")
# valid targets of per-family strategy routing (the "mixed" strategy);
# "auto" defers to the measured cost model
FAMILY_STRATEGY_CHOICES = ("s2", "s3", "fused", "auto")


def resolve_family_option(value, kernel: str, default):
    """Resolve a possibly per-family (mapping-valued) config knob for one
    kernel family.  Lookup order: the exact kernel id, then — for an
    epilogue-fused stage twin ``<base>+epi`` — its base kernel, then the
    ``"*"`` wildcard, then ``default``.  A plain (non-mapping) value
    applies to every family; ``None`` means ``default``."""
    if value is None:
        return default
    if not isinstance(value, Mapping):
        return value
    if kernel in value:
        return value[kernel]
    if kernel.endswith("+epi"):
        base = kernel[:-len("+epi")]
        if base in value:
            return value[base]
    return value.get("*", default)


@dataclass(frozen=True)
class AggregationConfig:
    """The paper's strategies as runtime knobs.

    strategy 1: larger sub-grids, a hydro config (``configs.sedov.CONFIG_16``)
                under any strategy, not a strategy of its own
    strategy 2: ``n_executors``    — concurrent launch queues (CUDA streams)
    strategy 3: ``max_aggregated`` — on-the-fly fusion cap (bucketed)

    ``strategy="s4"`` (``"sharded"``) drains each range over a mesh of
    ``shard_devices`` cards (0: every visible card).

    ``staging="device"`` reads ranges in place and stages per-task tensors
    into the region's slot ring; ``"host"`` stacks each bucket at launch
    (the seed's baseline).  ``fuse_epilogue`` runs each RK stage through
    the epilogue-fused stage families, under a strategy with ``run_stage``
    and device staging only (the runner falls back to the generic combine
    otherwise).

    Measured tuning: after ``autotune_warmup`` complete waves a region
    re-derives its bucket ladder from its queue-length histogram (at most
    ``compile_budget`` buckets, bucket 1 always kept), by launch count or,
    with ``cost_model=True``, by the predicted time per wave from each
    bucket's timed launches (the median of ``cost_samples`` samples).
    ``inner_chunk`` evaluates a bucket as sequential launches of that many
    slots (0: flat; ``"auto"``: timed at warmup).  ``flush_policy`` says
    whether a partial queue drains into an idle executor: always
    (``"eager"``), only at the learned wave peak (``"watermark"``) or when
    the cost model predicts the split no slower (``"cost"``); a name or a
    ``{kernel: policy}`` mapping.  ``family_strategies`` routes each family
    under ``strategy="mixed"`` to ``"s2"``, ``"s3"``, ``"fused"`` or
    ``"auto"`` (the measured choice), resolved by
    :func:`resolve_family_option`.  None of these changes a result.

    Containment: ``guard="finite"`` audits every launch at ``flush`` with
    one finite reduction and bisects a tripped bucket down to the culprit
    tasks (a task tripping ``quarantine_threshold`` times is quarantined:
    later trips run it alone).  A failed launch is retried up to
    ``max_bucket_retries`` times (backoff from ``retry_backoff_s``,
    doubled, each sleep capped at ``retry_backoff_max_s``); a bucket whose
    build fails, or whose launches keep failing, is banned and its tasks
    drained through smaller buckets.  ``launch_timeout_s > 0`` bounds each
    launch's completion (``LaunchTimeoutError``).  ``breaker_window > 0``
    arms a circuit breaker per family: ``breaker_threshold`` faults over
    the last ``breaker_window`` waves open it (the family drains at bucket
    1), and after ``breaker_cooldown`` waves a half-open probe closes or
    reopens it.  Only a fault changes a result.

    Warm start: ``tune_store`` (a directory, a ``TuneStore``, or None for
    the ``REPRO_TUNE_STORE`` environment variable) restores each family's
    tuned state at warmup instead of measuring it, and every retune writes
    it back; ``prior="roofline"`` seeds an unmeasured family's cost model
    and ladder from the roofline of its shapes.  Neither changes a result.
    """
    strategy: str = "s3"              # "s3" | "s2+s3" | "s2" | "mixed" |
                                      # "fused"
    n_executors: int = 1
    max_aggregated: int = 32
    buckets: Tuple[int, ...] = ()     # () -> powers of two up to max_aggregated
    launch_watermark: int = 1         # queue depth that forces a launch
    staging: str = "device"           # "device" | "host"
    autotune: bool = False
    autotune_warmup: int = 2          # complete waves per region before retune
    compile_budget: int = 4           # max distinct bucket sizes per ladder
    inner_chunk: object = 0           # int, or "auto"
    fuse_epilogue: bool = False       # epilogue-fused RK stages
    cost_model: bool = False
    cost_samples: int = 3             # timed samples per bucket (median)
    flush_policy: object = "eager"    # policy name, or {kernel: policy}
    family_strategies: Optional[Mapping[str, str]] = None
    # containment: "finite" checks every launch for non-finite output at
    # flush and bisects a tripped bucket down to its culprits
    guard: str = "off"                # "off" | "finite"
    max_bucket_retries: int = 2       # retries of a failed launch
    retry_backoff_s: float = 0.0      # first retry's sleep, doubled each
    retry_backoff_max_s: float = 1.0  # cap of one backoff sleep
    quarantine_threshold: int = 2     # trips before a task is quarantined
    launch_timeout_s: float = 0.0     # the launch watchdog's budget (0: off)
    breaker_window: int = 0           # waves a breaker counts (0: off)
    breaker_threshold: int = 3        # faults in the window that open it
    breaker_cooldown: int = 2         # open waves before a half-open probe
    # warm start: a store directory (or TuneStore; None: the
    # REPRO_TUNE_STORE environment variable), and the analytical prior
    tune_store: object = None
    prior: str = "off"                # "off" | "roofline"
    shard_devices: int = 0            # s4's mesh: cards (0: every card)

    def __post_init__(self):
        if self.strategy == "s1":
            raise ValueError(
                "strategy 's1' is not a launch strategy: the paper's "
                "strategy 1 is larger sub-grids, "
                "repro_torch.configs.sedov.CONFIG_16 (16^3), run under any "
                f"strategy of {PORTED_STRATEGIES}")
        if self.staging not in STAGING_MODES:
            raise ValueError(f"unknown staging mode {self.staging!r} — "
                             f"valid modes: {', '.join(STAGING_MODES)}")
        if self.guard not in GUARD_MODES:
            raise ValueError(f"unknown guard mode {self.guard!r} — valid "
                             f"modes: {', '.join(GUARD_MODES)}")
        if self.prior not in PRIOR_MODES:
            raise ValueError(f"unknown prior mode {self.prior!r} — valid "
                             f"modes: {', '.join(PRIOR_MODES)}")
        if self.shard_devices < 0:
            raise ValueError(f"shard_devices must be >= 0, got "
                             f"{self.shard_devices}")
        if self.n_executors < 1:
            raise ValueError(f"n_executors must be >= 1, got "
                             f"{self.n_executors}")
        if self.max_aggregated < 1:
            raise ValueError(f"max_aggregated must be >= 1, got "
                             f"{self.max_aggregated}")
        if self.launch_watermark < 1:
            raise ValueError(f"launch_watermark must be >= 1, got "
                             f"{self.launch_watermark}")
        if self.autotune_warmup < 0 or self.compile_budget < 1:
            raise ValueError(
                f"autotune_warmup must be >= 0 and compile_budget >= 1, got "
                f"{self.autotune_warmup} and {self.compile_budget}")
        if self.inner_chunk != "auto" and (
                isinstance(self.inner_chunk, bool)
                or not isinstance(self.inner_chunk, int)
                or self.inner_chunk < 0):
            raise ValueError(f"inner_chunk must be an int >= 0 or 'auto', "
                             f"got {self.inner_chunk!r}")
        if self.cost_samples < 1:
            raise ValueError(f"cost_samples must be >= 1, got "
                             f"{self.cost_samples}")
        policies = (self.flush_policy.values()
                    if isinstance(self.flush_policy, Mapping)
                    else (self.flush_policy,))
        for fp in policies:
            if fp not in FLUSH_POLICIES:
                raise ValueError(f"unknown flush_policy {fp!r} — valid "
                                 f"policies: {', '.join(FLUSH_POLICIES)}")
        for kernel, choice in (self.family_strategies or {}).items():
            if choice not in FAMILY_STRATEGY_CHOICES:
                raise ValueError(
                    f"family_strategies[{kernel!r}] = {choice!r} — valid "
                    f"assignments: {FAMILY_STRATEGY_CHOICES}")

    def bucket_sizes(self) -> Tuple[int, ...]:
        if self.buckets:
            return validate_ladder(self.buckets, self.max_aggregated)
        out, b = [], 1
        while b < self.max_aggregated:
            out.append(b)
            b *= 2
        out.append(self.max_aggregated)
        return tuple(dict.fromkeys(out))


def validate_ladder(buckets, cap: int) -> Tuple[int, ...]:
    """Validate a custom bucket ladder: positive ints, deduped, sorted
    ascending, containing 1, none above the ``max_aggregated`` cap.

    Bucket 1 is non-negotiable: the greedy drain covers any queue length k
    exactly only if a remainder of 1 has a bucket.
    """
    b = tuple(int(x) for x in buckets)
    problems = []
    if any(x <= 0 for x in b):
        problems.append("all bucket sizes must be positive")
    if len(set(b)) != len(b):
        problems.append("bucket sizes must be unique")
    if list(b) != sorted(b):
        problems.append("bucket sizes must be sorted ascending")
    if 1 not in b:
        problems.append(
            "the ladder must contain bucket size 1 — the greedy drain "
            "needs it to cover remainders exactly (no padding, no launch "
            "over garbage slots)")
    if b and max(b) > cap:
        problems.append(
            f"bucket {max(b)} exceeds max_aggregated={cap} and could "
            f"never launch — raise max_aggregated or drop the bucket")
    if problems:
        raise ValueError(
            f"invalid bucket ladder {buckets!r}: " + "; ".join(problems))
    return b


@dataclass(frozen=True)
class HydroConfig:
    """Octo-Tiger-style Sedov blast-wave scenario (paper Table II)."""
    name: str = "sedov"
    subgrid: int = 8                  # cells per edge (strategy-1 knob)
    ghost: int = 3                    # ghost-layer thickness (PPM needs 3)
    levels: int = 3                   # octree levels with AMR off
    n_fields: int = 5                 # rho, Sx, Sy, Sz, E
    gamma: float = 7.0 / 5.0
    cfl: float = 0.4
    blast_energy: float = 1.0
    rho0: float = 1.0
    domain: float = 1.0               # cube edge length
    dtype: str = "float32"

    @property
    def grids_per_edge(self) -> int:
        # AMR off: 2^levels leaf sub-grids per edge (paper Table II)
        return 2 ** self.levels

    @property
    def n_subgrids(self) -> int:
        return self.grids_per_edge ** 3

    @property
    def cells_total(self) -> int:
        return self.n_subgrids * self.subgrid ** 3

    @property
    def padded(self) -> int:
        return self.subgrid + 2 * self.ghost


@dataclass(frozen=True)
class AMRHydroConfig:
    """Two-level refined Sedov scenario: a coarse grid over the whole domain
    plus one centred fine patch at ``refine_ratio`` times the resolution.

    The fine level covers the central ``cover`` coarse cells per edge.  Each
    level decomposes into its own sub-grids; the per-level cell width ``h``
    is a per-task argument, so levels whose sub-grid shapes agree share one
    kernel family (one ``TaskSignature``), while mixed sub-grid sizes make
    two families aggregating through one executor.
    """
    name: str = "amr_sedov"
    coarse_subgrid: int = 8           # cells per coarse sub-grid edge
    fine_subgrid: int = 8             # cells per fine sub-grid edge
    ghost: int = 3                    # ghost-layer thickness (PPM needs 3)
    coarse_grids_per_edge: int = 2    # coarse level: (2*8)^3 cells
    cover: int = 8                    # coarse cells per edge under the patch
    refine_ratio: int = 2
    n_fields: int = 5
    gamma: float = 7.0 / 5.0
    cfl: float = 0.4
    blast_energy: float = 1.0
    rho0: float = 1.0
    domain: float = 1.0
    dtype: str = "float32"

    def __post_init__(self):
        if self.n_fine % self.fine_subgrid:
            raise ValueError("fine grid not divisible into fine sub-grids")
        if (self.n_coarse - self.cover) % 2:
            raise ValueError("fine patch cannot be centred on the coarse grid")
        # the prolongation ghost band must stay inside the coarse domain
        if self.offset < self.coarse_ghost_pad:
            raise ValueError("fine patch too close to the domain boundary "
                             "for the coarse-fine ghost exchange")

    @property
    def n_coarse(self) -> int:
        return self.coarse_grids_per_edge * self.coarse_subgrid

    @property
    def n_fine(self) -> int:
        return self.cover * self.refine_ratio

    @property
    def fine_grids_per_edge(self) -> int:
        return self.n_fine // self.fine_subgrid

    @property
    def offset(self) -> int:
        """Fine-patch origin, in coarse cells."""
        return (self.n_coarse - self.cover) // 2

    @property
    def h_coarse(self) -> float:
        return self.domain / self.n_coarse

    @property
    def h_fine(self) -> float:
        return self.h_coarse / self.refine_ratio

    @property
    def coarse_ghost_pad(self) -> int:
        """Coarse cells needed to prolongate one fine ghost band (ceil)."""
        return -(-self.ghost // self.refine_ratio)

    @property
    def n_subgrids_coarse(self) -> int:
        return self.coarse_grids_per_edge ** 3

    @property
    def n_subgrids_fine(self) -> int:
        return self.fine_grids_per_edge ** 3


@dataclass(frozen=True)
class GravityHydroConfig:
    """Self-gravitating Sedov scenario: every iteration submits TWO kernel
    families, the hydro RHS tasks and a per-sub-grid gravity solve
    (``repro_torch.kernels.gravity``), interleaved through one
    ``AggregationExecutor``, as Octo-Tiger's runtime aggregates its hydro
    and FMM kernels."""
    name: str = "gravity_sedov"
    hydro: HydroConfig = field(default_factory=HydroConfig)
    g_const: float = 1.0              # gravitational constant (scaled units)
    relax_iters: int = 8              # Jacobi sweeps per gravity task
