"""Typed configuration tree for seqrec_tpu_torch.

The port's own copy of ``seqrec_tpu/config.py``: the same dataclass tree,
field names and defaults, JSON round trip and dotted-path overrides, so every
``configs/*.json`` loads unchanged. Fields that only the JAX package reads
(compile cache, mesh layout, ...) are kept so that a config file means the
same thing to both packages; the port reads what its slices implement.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple


@dataclass
class ModelConfig:
    """Sequence-tower + head hyperparameters."""

    # "gru4rec" (recurrent tower) or "sasrec" (causal self-attention tower).
    arch: str = "gru4rec"
    # Embedding / hidden width. GRU hidden size == embed_dim unless set.
    embed_dim: int = 64
    hidden_dim: Optional[int] = None
    num_layers: int = 1
    # Recurrent-tower cell: "gru" (GRU4Rec proper) | "lstm" (the reference's
    # NMT-lineage `unit_type=lstm`). Ignored by the sasrec arch.
    cell_type: str = "gru"
    # Residual connections between stacked RNN layers (when widths match).
    residual: bool = False
    # SASRec-specific.
    num_heads: int = 1
    mlp_dim: Optional[int] = None  # defaults to 4*embed_dim
    max_len: int = 200
    dropout_rate: float = 0.1
    # Loss head: "full_softmax" | "sampled_softmax" | "bpr" | "top1"
    # (Hidasi et al. ICLR'16) | "bpr_max" (Hidasi & Karatzoglou CIKM'18).
    loss: str = "full_softmax"
    num_negatives: int = 100
    # Share the input embedding table with the output projection.
    tie_embeddings: bool = True
    # Personalization: add a learned per-user embedding to every input
    # position (row 0 = unknown user; table row-shards like the item table).
    use_user_embedding: bool = False
    # Numerics.
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # Use the hand-written kernels for hot ops (False = the plain PyTorch
    # versions in ops/reference.py). The name is the JAX package's, kept so
    # config files mean the same thing to both packages.
    use_pallas: bool = True
    # Rematerialize transformer blocks in backward (jax.checkpoint): trades
    # ~1/3 more FLOPs for O(layers) less activation memory — for long-T
    # SASRec at large batch (SURVEY.md §5.7 long-context mechanism).
    remat: bool = False

    @property
    def hidden(self) -> int:
        return self.hidden_dim if self.hidden_dim is not None else self.embed_dim


@dataclass
class DataConfig:
    """Dataset + batching hyperparameters."""

    # "ml-100k" | "ml-1m" | "beauty" | "steam" | "rsc15" | "synthetic".
    dataset: str = "ml-100k"
    data_dir: str = "data"
    # Per-device batch size (global batch = batch_size * num_devices).
    batch_size: int = 128
    max_len: int = 200
    # Length buckets: sequences are padded up to the smallest bucket that fits;
    # one compiled train step per bucket. Empty => single fixed shape max_len.
    buckets: Tuple[int, ...] = ()
    shuffle_buffer: int = 10_000
    seed: int = 0
    # Negative sampling for training loss: "uniform" | "log_uniform".
    neg_sampler: str = "log_uniform"
    # Session-parallel packed streaming (original GRU4Rec regime): dense
    # [B, max_len] windows with zero padding waste, RNN state carried across
    # windows (truncated BPTT), state reset at session starts. RNN towers
    # only; disables bucketing (one window shape). Best for short-session
    # datasets (rsc15).
    session_parallel: bool = False
    # Use the native C++ threaded data engine when built (make -C native);
    # falls back to the Python pipeline automatically.
    use_native_loader: bool = True
    # Host→device prefetch depth: a background thread stages this many
    # upcoming batches in device HBM so the hot loop never waits on the host
    # (SURVEY.md §2 #16). 2 = double-buffering; 0 disables (synchronous
    # next+put per step, debug only).
    prefetch_to_device: int = 2
    # Synthetic-dataset knobs (BASELINE.json:11 large-catalog config).
    synthetic_num_items: int = 10_000
    synthetic_num_users: int = 2_000
    synthetic_zipf_a: float = 1.1
    synthetic_min_len: int = 5
    synthetic_max_len: int = 60
    min_seq_len: int = 2


@dataclass
class TrainConfig:
    num_steps: int = 2_000
    learning_rate: float = 1e-3
    optimizer: str = "adam"  # "adam" | "adagrad" | "sgd"
    weight_decay: float = 0.0
    grad_clip_norm: float = 5.0
    lr_schedule: str = "constant"  # "constant" | "cosine" | "warmup_cosine"
    warmup_steps: int = 100
    log_every: int = 50
    eval_every: int = 500
    checkpoint_every: int = 1_000
    keep_checkpoints: int = 3
    seed: int = 42
    out_dir: str = "runs/default"
    resume: bool = False
    profile_dir: Optional[str] = None
    # [start, stop] trace window. Like log/eval/checkpoint cadences, the
    # window quantizes to steps_per_call group boundaries: the trace starts
    # at the first group containing `start` and stops after the group
    # containing `stop`, so it can include up to K-1 extra steps either side.
    profile_steps: Tuple[int, int] = (10, 20)
    # Detect non-finite loss/gradients and HALT with the failing step number
    # (SURVEY.md §5.2). The check is a cheap scalar computed on device every
    # step; fetching it synchronizes the loop, so leave off for benchmarks.
    debug_nans: bool = False
    # Replace non-finite gradients with zeros and keep training (the lenient
    # knob; orthogonal to debug_nans, which halts instead).
    sanitize_nans: bool = False
    # Mirror scalar metrics to TensorBoard (out_dir/tb) in addition to the
    # host-0 JSONL stream (SURVEY.md §5.5).
    tensorboard: bool = False
    # Fault-injection for resume tests (SURVEY.md §5.3): exit after this step.
    fail_after_step: Optional[int] = None
    # Large-catalog mode: never materialize a dense [V, D] gradient for the
    # item table. The step gathers the batch's unique rows, differentiates
    # through the sub-table, and scatter-updates only touched rows (and their
    # optimizer-state rows). Requires a sampled loss; tied and untied output
    # tables both work (untied gets its own unique set + sub-table).
    # adagrad/sgd match dense updates exactly, adam becomes lazy-adam
    # (untouched rows skip moment decay). See train/sparse_embed.py.
    sparse_embedding_update: bool = False
    # Cap on the sparse step's unique-row budget (0 = exact: budget covers
    # every id the step could touch, B*T*2 + S for tied tables). The exact
    # budget is worst-case-static — a Zipf batch touches far fewer distinct
    # rows — and it sizes BOTH the per-step sub-table work and, when the
    # table is row-sharded, the [K, D] collectives (benchmarks/scaling.py
    # --analyze). With a cap, ids past the budget degrade SAFELY for that
    # step: they embed as a zeros sentinel row and their table rows receive
    # no update (never a wrong neighbor's row — overflow-safe remapping).
    # Production embedding-system trade; leave 0 for exact training.
    sparse_unique_budget: int = 0
    # The JAX package's persistent XLA compilation cache directory. Read and
    # unused here: nothing in eager torch compiles. The port's persistent
    # build cache is ops/_build.py's content-hashed seqrec_tpu_torch/build/
    # (listed in .gitignore); moving the builds to this key's
    # ~/.cache/seqrec_xla would take them out of the checkout.
    compilation_cache_dir: str = "~/.cache/seqrec_xla"
    # Steps executed per compiled call: fit() groups this many consecutive
    # same-bucket batches into ONE [K, B, T+2] wire transfer and ONE
    # lax.scan'd executable, amortizing per-step host dispatch + H2D
    # overhead (the measured e2e/compute gap on the relay). The math is
    # IDENTICAL to K single steps — same batches, order, and per-step RNG
    # (folded on state.step) — only the host cadence quantizes: log/eval/
    # checkpoint fire at the first group boundary past their step. Ignored
    # (forced to 1) under debug_nans, which needs per-step halt granularity;
    # session-parallel and non-canonical batches fall back to single steps.
    steps_per_call: int = 1


@dataclass
class EvalConfig:
    # "full" = rank against the full catalog; "sampled" = 1 positive vs.
    # `num_negatives` sampled negatives (the SASRec-paper 100-neg protocol).
    protocol: str = "full"
    num_negatives: int = 100
    ks: Tuple[int, ...] = (5, 10, 20)
    batch_size: int = 256
    max_batches: Optional[int] = None
    # Full protocol on one device: when the [B, V] score matrix would exceed
    # ~512 MB the harness streams the catalog in blocks of this many items
    # (eval/chunked.py). None = auto block size; set explicitly to force
    # chunking (tests) or tune the block.
    full_chunk_items: Optional[int] = None
    # Full protocol: mask each user's own (seen) history so it cannot outrank
    # the held-out target — the GRU4Rec-paper convention ranks against the
    # whole catalog; many SASRec-lineage setups exclude seen items. Applies
    # to the dense, chunked, and sharded full-eval paths (the sampled
    # protocol already excludes history when drawing negatives).
    exclude_history: bool = False
    seed: int = 123


@dataclass
class MeshConfig:
    """Device-mesh layout. data axis = DP over the tower; model axis =
    row-sharding (TP) of the embedding tables (SURVEY.md §2.2)."""

    data_axis: int = -1  # -1 = all remaining devices
    model_axis: int = 1
    # Row-shard embedding tables over the model axis when model_axis > 1.
    shard_embeddings: bool = False
    # Deduplicate ids per batch before the collective exchange (component #3).
    dedup_lookup: bool = True


@dataclass
class RunConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    # ---- serialization -------------------------------------------------

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def from_dict(cls, d: dict) -> "RunConfig":
        return cls(
            model=_build(ModelConfig, d.get("model", {})),
            data=_build(DataConfig, d.get("data", {})),
            train=_build(TrainConfig, d.get("train", {})),
            eval=_build(EvalConfig, d.get("eval", {})),
            mesh=_build(MeshConfig, d.get("mesh", {})),
        )

    @classmethod
    def from_json(cls, s: str) -> "RunConfig":
        return cls.from_dict(json.loads(s))

    @classmethod
    def load(cls, path: str) -> "RunConfig":
        with open(path) as f:
            return cls.from_json(f.read())

    # ---- CLI overrides -------------------------------------------------

    def apply_overrides(self, overrides: List[str]) -> "RunConfig":
        """Apply ``section.key=value`` overrides (values parsed as JSON,
        falling back to string)."""
        d = self.to_dict()
        for ov in overrides:
            ov = ov.lstrip("-")
            if "=" not in ov:
                raise ValueError(f"override must be key=value, got {ov!r}")
            path, raw = ov.split("=", 1)
            keys = path.split(".")
            node: Any = d
            for k in keys[:-1]:
                if k not in node:
                    raise KeyError(f"unknown config section {k!r} in {path!r}")
                node = node[k]
            if keys[-1] not in node:
                raise KeyError(f"unknown config key {keys[-1]!r} in {path!r}")
            try:
                val = json.loads(raw)
            except json.JSONDecodeError:
                val = raw
            node[keys[-1]] = val
        return RunConfig.from_dict(d)


def _build(cls, d: dict):
    """Construct dataclass `cls` from dict, tolerating tuple fields and
    rejecting unknown keys (catches config typos early)."""
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - names
    if unknown:
        raise KeyError(f"unknown {cls.__name__} keys: {sorted(unknown)}")
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name in d:
            v = d[f.name]
            if isinstance(v, list):
                v = tuple(v)
            kwargs[f.name] = v
    return cls(**kwargs)
