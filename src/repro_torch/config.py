"""The configurations: copies of the reference's ``SimConfig``,
``ModelConfig``, ``ShapeConfig`` (and ``SHAPES``), ``TrainConfig`` and
``describe``.

Field for field and default for default the dataclasses of ``repro.config``
(tests hold them equal), kept here so that the port imports nothing of
the reference package. ``use_kernels`` and ``fused_window_stats`` stay
fields so that configs compare equal, but the port does not read them: a
CUDA tensor always takes the hand-written kernel and a CPU tensor its plain
PyTorch version.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# Model configuration (the LM substrate)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ModelConfig:
    """Architecture description for the layer-pattern compiler in
    models/model.py. ``remat_policy``, ``chunked_ce``, ``ce_chunks`` and
    ``bf16_weight_gather`` are read by the training path; ``moe_impl`` and
    ``pad_head_shard`` by the reference's sharding paths only, kept here so
    that configs compare equal."""

    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    head_dim: int = 0                # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # --- MoE ---
    n_experts: int = 0               # routed experts (0 = dense MLP)
    moe_top_k: int = 0
    moe_d_ff: int = 0                # per-expert hidden dim
    n_shared_experts: int = 0        # qwen2-moe style always-on experts
    shared_d_ff: int = 0             # hidden dim of each shared expert
    moe_period: int = 1              # every `moe_period`-th layer is MoE
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01    # load-balancing aux loss

    # --- SSM / hybrid ---
    ssm_state: int = 0               # N (state size); 0 = no mamba layers
    ssm_head_dim: int = 64           # P
    ssm_expand: int = 2              # d_inner = expand * d_model
    ssm_chunk: int = 128             # SSD chunk length
    ssm_conv: int = 4                # causal conv width
    attn_period: int = 0             # hybrid: 1 attn layer per `attn_period`
    attn_offset: int = 0             # index of the attn layer inside a period

    # --- modality frontends (stubs) ---
    n_codebooks: int = 1             # musicgen: summed embeds, K heads
    n_prefix: int = 0                # llava: patch embeddings prepended

    # --- numerics / impl ---
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    attention_impl: str = "xla"      # xla | pallas (pallas: kernel F)
    remat_policy: str = "full"       # none | minimal | full
    chunked_ce: bool = False         # streaming-logsumexp CE over vocab chunks
    ce_chunks: int = 8
    moe_impl: str = "gspmd"          # gspmd | shard_map
    pad_head_shard: bool = False
    bf16_weight_gather: bool = False
    prefill_microbatches: int = 1    # process the prompt batch in chunks
    logits_softcap: float = 0.0

    # ----- derived -----
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.resolved_head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.resolved_head_dim

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256."""
        return _round_up(self.vocab_size, 256)

    def layer_pattern(self) -> Tuple[Tuple[str, str], ...]:
        """Return the repeating ``(mixer, mlp)`` pattern.

        The full stack is ``n_layers // len(pattern)`` repeats of this
        pattern. Mixer in {attn, mamba}; mlp in {dense, moe, none}.
        """
        period = 1
        if self.attn_period > 1:
            period = self.attn_period
        if self.n_experts and self.moe_period > 1:
            period = max(period, self.moe_period)
        if self.attn_period > 1 and self.n_experts and self.moe_period > 1:
            period = math.lcm(self.attn_period, self.moe_period)
        pattern = []
        for i in range(period):
            if self.ssm_state and self.attn_period == -1:
                mixer = "mamba"                      # pure SSM
            elif self.ssm_state and self.attn_period > 1:
                mixer = ("attn" if (i % self.attn_period) == self.attn_offset
                         else "mamba")
            else:
                mixer = "attn"
            if self.d_ff == 0 and not self.n_experts:
                mlp = "none"                          # mamba2-780m style
            elif self.n_experts and (i % self.moe_period) == (
                    self.moe_period - 1 if self.moe_period > 1 else 0):
                mlp = "moe"
            else:
                mlp = "dense"
            pattern.append((mixer, mlp))
        assert self.n_layers % len(pattern) == 0, (
            f"{self.name}: n_layers={self.n_layers} not divisible by "
            f"pattern period {len(pattern)}")
        return tuple(pattern)

    @property
    def n_repeats(self) -> int:
        return self.n_layers // len(self.layer_pattern())

    def has_attention(self) -> bool:
        return any(m == "attn" for m, _ in self.layer_pattern())

    def has_mamba(self) -> bool:
        return any(m == "mamba" for m, _ in self.layer_pattern())

    def is_subquadratic(self) -> bool:
        """True if the arch can run the 512K-token long-context decode shape."""
        if not self.has_attention():
            return True
        # hybrids with sparse attention layers qualify (jamba: 1 attn per 8)
        pat = self.layer_pattern()
        frac_attn = sum(1 for m, _ in pat if m == "attn") / len(pat)
        return frac_attn <= 0.25

    def param_count(self) -> int:
        """Analytic parameter count (used for 6ND model-FLOPs)."""
        d, v = self.d_model, self.padded_vocab
        hd = self.resolved_head_dim
        total = v * d                                    # embedding
        if not self.tie_embeddings:
            total += d * v * self.n_codebooks            # output head(s)
        if self.n_codebooks > 1:
            total += (self.n_codebooks - 1) * v * d      # extra codebook embeds
        for mixer, mlp in self.layer_pattern() * self.n_repeats:
            total += d                                   # pre-mixer norm
            if mixer == "attn":
                total += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
                if self.qk_norm:
                    total += 2 * hd
            else:                                        # mamba2 block
                din, h, n = self.d_inner, self.ssm_heads, self.ssm_state
                total += d * (2 * din + 2 * n + h)       # in_proj (z,x,B,C,dt)
                total += self.ssm_conv * (din + 2 * n)   # conv
                total += 3 * h + din                     # A, D, dt_bias, norm
                total += din * d                         # out_proj
            if mlp == "dense":
                total += d + 3 * d * self.d_ff
            elif mlp == "moe":
                total += (d + self.n_experts * 3 * d * self.moe_d_ff
                          + d * self.n_experts)
                total += self.n_shared_experts * 3 * d * self.shared_d_ff
        total += d                                       # final norm
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k + shared experts only)."""
        if not self.n_experts:
            return self.param_count()
        d = self.d_model
        dense_like = replace(self, n_experts=0, moe_top_k=0,
                             n_shared_experts=0, d_ff=self.d_ff or 1)
        base = dense_like.param_count()
        # remove the placeholder dense MLPs just added where MoE layers were
        n_moe = sum(1 for _, m in self.layer_pattern()
                    if m == "moe") * self.n_repeats
        n_dense_orig = sum(1 for _, m in self.layer_pattern()
                           if m == "dense") * self.n_repeats
        base -= (n_moe + n_dense_orig) * (d + 3 * d * (self.d_ff or 1))
        base += n_dense_orig * (d + 3 * d * self.d_ff)
        per_moe = (d + self.moe_top_k * 3 * d * self.moe_d_ff
                   + d * self.n_experts
                   + self.n_shared_experts * 3 * d * self.shared_d_ff)
        return base + n_moe * per_moe


def describe(cfg: ModelConfig) -> str:
    n = cfg.param_count()
    na = cfg.active_param_count()
    pat = cfg.layer_pattern()
    return (f"{cfg.name}: {cfg.n_layers}L d={cfg.d_model} "
            f"H={cfg.n_heads}/{cfg.n_kv_heads} "
            f"dff={cfg.d_ff or cfg.moe_d_ff} vocab={cfg.vocab_size} "
            f"params={n/1e9:.2f}B active={na/1e9:.2f}B "
            f"pattern={len(pat)}x{cfg.n_repeats}")


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int
    num_microbatches: int = 1


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256,
                            num_microbatches=8),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32,
                               num_microbatches=1),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


# ---------------------------------------------------------------------------
# Training runtime configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    seed: int = 0
    num_microbatches: int = 1
    grad_compression: str = "none"    # none | int8_ef
    checkpoint_every: int = 50
    keep_checkpoints: int = 3
    checkpoint_dir: str = "/tmp/repro_ckpt"
    async_checkpoint: bool = True
    log_every: int = 10


# ---------------------------------------------------------------------------
# Simulator configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SimConfig:
    """AGOCS engine configuration.

    Defaults mirror the paper: 5-second collection windows, 5 parser workers,
    buffers of <=1e6 events / 30 sim-minutes ahead, GCD cell with 12.5K nodes.
    """
    max_nodes: int = 12_500
    max_tasks: int = 262_144          # live-task slots (GCD ~140K running)
    max_events_per_window: int = 8_192
    window_us: int = 5_000_000        # 5 sim-seconds (paper's collection tick)
    n_resources: int = 3              # cpu, memory, disk
    n_usage_stats: int = 8            # cpu, canon-mem, assigned-mem, page-cache,
                                      # disk-io-time, disk-space, cpi, mai
    n_attr_slots: int = 16            # node attribute columns
    max_constraints: int = 6          # per-task constraint slots
    n_parser_workers: int = 5         # paper's 5 Akka actors
    buffer_windows: int = 360         # 30 sim-minutes of 5s windows
    buffer_max_events: int = 1_000_000
    speed_factor: float = 0.0         # 0 = as-fast-as-possible; else real-time x N
    scheduler: str = "greedy"
    sched_batch: int = 1_024          # max pending tasks considered per window
    seed: int = 0
    use_kernels: bool = False         # read by the reference only: the
                                      # port dispatches on the tensor's
                                      # device (CUDA -> kernel, CPU -> plain)
    incremental_accounting: bool = True
                                      # maintain node_reserved/node_used by
                                      # per-event deltas (O(events) per window)
                                      # instead of full segment-sum recomputes
                                      # (O(max_tasks), three times per window).
                                      # False restores the pre-delta full
                                      # recompute path — kept for the
                                      # equivalence suite and as the fallback
                                      # if a trace violates the pipeline's
                                      # one-update-per-(slot, field-group)
                                      # window guarantee
    resync_windows: int = 64          # full segment-sum resync cadence under
                                      # incremental accounting: the drivers
                                      # recompute both tallies from the task
                                      # table every ~resync_windows windows
                                      # (rounded up to a batch boundary),
                                      # bounding float accumulation drift.
                                      # 0 disables the resync
    fused_window_stats: bool = True   # read by the reference only: the
                                      # port always builds each stats row
                                      # from the fused pass
                                      # (kernels/window_stats); its
                                      # pre-fusion body
                                      # (core.stats.window_stats_ref) is the
                                      # oracle tests call directly
    stats_stride: int = 1             # emit a stats row every k-th window
                                      # (headless sweeps): the engines scan
                                      # k windows per stats row, so skipped
                                      # windows pay ZERO stats cost. Counters
                                      # are cumulative in SimState (and the
                                      # fleet's per-window injected count is
                                      # accumulated across the chunk), so no
                                      # events are lost — each emitted row
                                      # equals the corresponding stride-1
                                      # row. Drivers round batch_windows up
                                      # to a multiple of the stride; a
                                      # short tail batch still emits a final
                                      # partial row so the run always ends
                                      # on a reported state
    storm_max_victims: int = 0        # per-window cap on eviction-storm
                                      # victims (scenario fleets). Victims
                                      # up to the cap are *compacted* — a
                                      # searchsorted over the victim cumsum
                                      # gathers the <=V victim rows, and the
                                      # incremental accounting debit becomes
                                      # an O(V) delta scatter instead of a
                                      # masked O(max_tasks) segment-sum per
                                      # storm lane per window. 0 = auto
                                      # (max_tasks // 8, at least 64);
                                      # >= max_tasks disables the cap AND
                                      # the compaction (the legacy
                                      # masked-segment-sum debit). NOTE a
                                      # *binding* cap truncates the storm
                                      # AND keeps the lowest-slot hits
                                      # (slot order, not a uniform
                                      # subsample) — size it above
                                      # storm_frac x expected running tasks,
                                      # or set >= max_tasks for unbounded
                                      # storms
    trace_time_shift_us: int = 600_000_000  # GCD's 10-minute shift
    scenario_salt: int = 0x5DEECE66   # seeds the deterministic perturbation
                                      # hashes of the what-if scenario fleet
                                      # (repro/scenarios) — change to resample
                                      # outage/thinning victim sets
    inject_slots: int = 0             # event rows per window reserved for
                                      # scenario event *injection* (the last
                                      # inject_slots rows of every packed
                                      # window stay PAD; perturb.py fills them
                                      # with synthesised SUBMITs, so arrival
                                      # amplification > 1 adds real load)
    inject_task_slots: int = 0        # task-slot pool reserved for injected
                                      # tasks at the top of the task table
                                      # (0 = auto-size from inject_slots);
                                      # injected slot ids wrap modulo the pool
    sched_dispatch: str = "auto"      # fleet scheduler dispatch: 'auto' goes
                                      # switchless (grouped proposal-table
                                      # evaluation, no lax.switch) whenever
                                      # every lane's scheduler registered a
                                      # table form, falling back to the
                                      # lax.switch path otherwise; 'switch'
                                      # forces the fallback; 'table' demands
                                      # switchless and errors if any lane's
                                      # scheduler is opaque (no table form)
    commit_tile_p: int = 0            # placement-commit task tile rows per
                                      # grid step (0 = kernel default: whole
                                      # batch under interpret, 128 on TPU)
    commit_tile_n: int = 0            # node-streaming tile for the commit /
                                      # fused scheduler pass: 0 keeps the
                                      # node dim whole per grid step; k > 0
                                      # streams (B, k) score blocks with a
                                      # cross-tile argmax carry so the pass
                                      # holds at full-cell node counts
                                      # (N=12,500) without an HBM-resident
                                      # (B, P, N) preference tensor

    def __post_init__(self):
        if self.sched_dispatch not in ("auto", "switch", "table"):
            raise ValueError(
                f"sched_dispatch={self.sched_dispatch!r} not in "
                "('auto', 'switch', 'table')")
        if self.commit_tile_p < 0 or self.commit_tile_n < 0:
            raise ValueError("commit_tile_p / commit_tile_n must be >= 0 "
                             "(0 = kernel default / whole node dim)")
        if self.inject_slots < 0 or self.inject_task_slots < 0:
            raise ValueError("inject_slots / inject_task_slots must be >= 0")
        if self.resync_windows < 0:
            raise ValueError("resync_windows must be >= 0 (0 disables)")
        if self.stats_stride < 1:
            raise ValueError("stats_stride must be >= 1 (1 = every window)")
        if self.storm_max_victims < 0:
            raise ValueError("storm_max_victims must be >= 0 (0 = auto)")
        if self.inject_slots >= self.max_events_per_window:
            raise ValueError(
                f"inject_slots={self.inject_slots} leaves no event rows "
                f"(max_events_per_window={self.max_events_per_window})")
        pool = self.resolved_inject_task_slots
        if pool >= self.max_tasks:
            raise ValueError(
                f"inject task pool {pool} leaves no real task slots "
                f"(max_tasks={self.max_tasks})")
        if self.inject_slots and pool < self.inject_slots:
            raise ValueError(
                f"inject task pool {pool} < inject_slots="
                f"{self.inject_slots}: one window's injections would "
                "collide with each other")

    @property
    def resolved_inject_task_slots(self) -> int:
        """Task-slot pool for injected tasks (auto: 64 windows' worth)."""
        if not self.inject_slots:
            return 0
        return self.inject_task_slots or min(self.max_tasks // 4,
                                             self.inject_slots * 64)

    @property
    def resolved_storm_max_victims(self) -> int:
        """Eviction-storm victim cap (auto: max_tasks // 8, at least 64).

        Values >= max_tasks mean 'uncapped': the storm keeps the legacy
        masked segment-sum debit instead of the victim-compacted scatter.
        """
        if self.storm_max_victims:
            return min(self.storm_max_victims, self.max_tasks)
        return min(max(self.max_tasks // 8, 64), self.max_tasks)

    @property
    def real_task_slots(self) -> int:
        """Task slots available to the parser; [real_task_slots, max_tasks)
        is the injection pool, so injected ids never collide with trace ids."""
        return self.max_tasks - self.resolved_inject_task_slots

    @property
    def events_per_window(self) -> int:
        """Rows available to parsed (real) events in each packed window."""
        return self.max_events_per_window - self.inject_slots

    def scaled(self, nodes: int, tasks: int) -> "SimConfig":
        return replace(self, max_nodes=nodes, max_tasks=tasks)


REDUCED_SIM = SimConfig(max_nodes=64, max_tasks=512, max_events_per_window=256,
                        n_attr_slots=8, max_constraints=4, buffer_windows=16,
                        buffer_max_events=4096, sched_batch=64)
