"""Experiment configuration tree and the command line's dotted overrides.

The port's copy of what its experiments read from ``areal_tpu/api/
cli_args.py``: the dataclasses of the PPO experiments (field names as the
reference's, so launch commands carry over), :func:`apply_overrides` with
``_coerce`` (``a.b.c=value`` onto nested dataclasses, typed by the field's
annotation; an unknown key raises :class:`ConfigError` with the closest
names), :func:`print_config_help`, :func:`validate_config` and the YAML
dump and load (:func:`save_yaml`, :func:`load_yaml`, :func:`to_yaml_dict`,
:func:`merge_dict`; reference ``:800-850``).

Differences: ``backend`` is ``cuda`` (default) or ``cpu``, the device every
worker runs on; ``n_gpus_per_node`` defaults to 1, the port's one card; a
model role's ``backend`` defaults to ``torch_train``; a list field also
takes a JSON list (``sentinel.rules=[{...}]``: the reference sets rule
packs through its YAML). Left out because a rank holds exactly one
device: ``trainer_dist_procs`` (the trainer's processes are the world of
its ``allocation_mode`` spec, ``experiments/common.py trainer_world``) and
``trainer_dist_devices_per_proc`` (virtual CPU devices per process). ``yaml`` is imported inside the YAML functions
only; where it is absent, :func:`save_yaml` writes the same dict as JSON
(a YAML document that ``yaml.safe_load`` reads) and :func:`load_yaml`
reads it with ``json``; a file that neither reads raises. Left out with
the piece that reads it: ``compile_watch.storm_warmup_calls`` (no jitted
function to watch); left out because nothing reads them:
``dataset.valid_bs_n_seqs`` and ``dataset.fill_to_max_length`` of the SFT
dataset, and ``auto_eval_config.eval_job_image``,
``initial_checkpoint_path`` and ``prompt_type``.
"""

from __future__ import annotations

import dataclasses
import difflib
import json
import os
import tempfile
import typing
from typing import Any, Dict, List, Optional

from areal_tpu_torch.api.data import MicroBatchSpec
from areal_tpu_torch.api.model import GenerationHyperparameters
from areal_tpu_torch.api.train_config import (
    AutoscaleConfig,
    CompileWatchConfig,
    DurabilityConfig,
    ExperimentSaveEvalControl,
    FaultToleranceConfig,
    GoodputConfig,
    OptimizerConfig,
    RewardServiceConfig,
    SentinelConfig,
    ServingConfig,
    TelemetryConfig,
    WeightSyncConfig,
)
from areal_tpu_torch.base.name_resolve import NameResolveConfig


@dataclasses.dataclass
class ModelFamily:
    """Reference cli_args.py:99. ``_class`` names the HF family."""

    _class: str = "qwen3"
    is_critic: bool = False


@dataclasses.dataclass
class ModelTrainEvalConfig:
    """One model role (reference cli_args.py:433)."""

    type: ModelFamily = dataclasses.field(default_factory=ModelFamily)
    path: str = ""  # an HF model directory
    init_from_scratch: bool = False
    gradient_checkpointing: bool = True
    bf16: bool = True
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig)
    backend: str = "torch_train"
    # A fabricated tiny model for CPU tests: e.g. actor.tiny.vocab_size=258.
    tiny: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class MFCConfig:
    """Per-MFC runtime knobs (reference cli_args.py:496)."""

    mb_spec: MicroBatchSpec = dataclasses.field(default_factory=MicroBatchSpec)


@dataclasses.dataclass
class PPOHyperparameters:
    """Reference cli_args.py:597 (PPOHyperparameters). Here, beside the
    other config blocks, so that the experiment trees import no torch."""

    gen: GenerationHyperparameters = dataclasses.field(
        default_factory=GenerationHyperparameters
    )
    ppo_n_minibatches: int = 4
    eps_clip: float = 0.2
    c_clip: Optional[float] = None
    value_eps_clip: float = 0.2
    early_stop_imp_ratio: float = 5.0
    reward_output_scaling: float = 1.0
    reward_output_bias: float = 0.0
    max_reward_clip: float = 20.0
    mask_no_eos_with_zero: bool = False
    discount: float = 1.0
    gae_lambda: float = 1.0
    adv_norm: bool = True
    kl_ctl: float = 0.1
    use_adaptive_kl_ctl: bool = False
    adaptive_kl_target: float = 6.0
    adaptive_kl_horizon: float = 10000.0
    disable_value: bool = False  # GRPO: no critic
    value_norm: bool = True
    value_norm_beta: float = 0.99995
    value_norm_eps: float = 1e-5
    group_size: int = 1
    group_adv_norm: bool = False
    use_decoupled_loss: bool = False
    behav_imp_weight_cap: Optional[float] = None
    recompute_logprob: bool = False


@dataclasses.dataclass
class PromptOnlyDatasetConfig:
    """Reference cli_args.py:44."""

    path: str = ""
    max_prompt_len: int = 1024
    train_bs_n_seqs: int = 256


@dataclasses.dataclass
class PromptAnswerDatasetConfig:
    """SFT dataset (reference cli_args.py:58)."""

    path: str = ""
    max_seqlen: int = 1024
    train_bs_n_seqs: int = 256


@dataclasses.dataclass
class ClusterSpecConfig:
    """Reference cli_args.py:896."""

    fileroot: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "areal_tpu", "experiments"))
    name_resolve: NameResolveConfig = dataclasses.field(
        default_factory=NameResolveConfig)


@dataclasses.dataclass
class WandBConfig:
    mode: str = "disabled"


@dataclasses.dataclass
class TensorBoardConfig:
    path: Optional[str] = None


@dataclasses.dataclass
class AutomaticEvaluatorConfig:
    """Reference cli_args.py:791 (AutomaticEvaluator)."""

    data_names: str = "aime24"
    max_gen_tokens: int = 32768
    max_concurrent_jobs: int = 1
    # pass@k sampling evaluation (apps/eval_ckpt.py): k > 1 draws k
    # temperature-sampled generations per prompt and the evaluator writes
    # pass@1 / pass@k / pass^k per task kind for every saved checkpoint;
    # k = 1 keeps the greedy single-sample accuracy.
    eval_k: int = 1
    temperature: float = 0.6


@dataclasses.dataclass
class BaseExperimentConfig:
    """Reference cli_args.py:944 (BaseExperimentConfig), what the port
    reads. ``mode`` is ``local`` (every worker on this host)."""

    experiment_name: str = "areal-tpu"
    trial_name: str = ""
    mode: str = "local"
    backend: str = "cuda"  # cuda | cpu: the device of every worker
    # disabled | resume | auto | fault: "resume" restores from the last
    # recover checkpoint; "auto"/"fault" also relaunch the whole experiment
    # (with recovery) when a worker's death escalates, up to
    # recover_retries times.
    recover_mode: str = "disabled"
    recover_retries: int = 1
    allocation_mode: str = ""
    n_nodes: int = 1
    n_gpus_per_node: int = 1
    seed: int = 1
    cluster: ClusterSpecConfig = dataclasses.field(
        default_factory=ClusterSpecConfig)
    exp_ctrl: ExperimentSaveEvalControl = dataclasses.field(
        default_factory=ExperimentSaveEvalControl)
    wandb: WandBConfig = dataclasses.field(default_factory=WandBConfig)
    tensorboard: TensorBoardConfig = dataclasses.field(
        default_factory=TensorBoardConfig)
    # Score every saved checkpoint in an eval subprocess on the run's
    # device (apps/evaluator.py).
    auto_eval: bool = False
    auto_eval_config: AutomaticEvaluatorConfig = dataclasses.field(
        default_factory=AutomaticEvaluatorConfig)
    # Trainer -> generation-fleet weight transport: stream | disk.
    weight_sync: WeightSyncConfig = dataclasses.field(
        default_factory=WeightSyncConfig)
    # Observability, every block off by default: `telemetry.enabled=true`
    # turns on cross-worker metrics, trace spans, the merged Prometheus
    # /metrics and the profiler trigger; goodput, compile_watch (the
    # kernel build and device-memory gauges) and the sentinel need it.
    telemetry: TelemetryConfig = dataclasses.field(
        default_factory=TelemetryConfig)
    goodput: GoodputConfig = dataclasses.field(default_factory=GoodputConfig)
    sentinel: SentinelConfig = dataclasses.field(
        default_factory=SentinelConfig)
    compile_watch: CompileWatchConfig = dataclasses.field(
        default_factory=CompileWatchConfig)
    # The generation fleet's serving engine, off by default:
    # `serving.enabled=true` turns on request classes with 429/413
    # admission, priority batches, prefix-reuse KV and bounded shapes.
    serving: ServingConfig = dataclasses.field(default_factory=ServingConfig)
    # Launcher-level supervision and liveness leases: stateless workers
    # respawn in place, a trainer death escalates to the relaunch loop.
    fault_tolerance: FaultToleranceConfig = dataclasses.field(
        default_factory=FaultToleranceConfig)
    # The sandboxed reward fleet, off by default:
    # `reward_service.enabled=true` spawns CPU-only reward workers, and the
    # rollout and trainer reward paths grade there.
    reward_service: RewardServiceConfig = dataclasses.field(
        default_factory=RewardServiceConfig)
    # The elastic generation fleet, off by default: `autoscale.enabled=true`
    # sizes the fleet from the manager's signals, spawns dynamic servers and
    # cordons stragglers (the cordon API works either way).
    autoscale: AutoscaleConfig = dataclasses.field(
        default_factory=AutoscaleConfig)
    # The durable trajectory spool, off by default: `durability.enabled=true`
    # turns on at-least-once rollout -> trainer delivery with acks after the
    # step commits, and crash replay with idempotent ingest.
    durability: DurabilityConfig = dataclasses.field(
        default_factory=DurabilityConfig)
    # Test and bring-up runs: the byte-level mock tokenizer.
    mock_tokenizer: bool = False

    def _device(self) -> Optional[str]:
        """Every worker's device: the CPU only when asked for."""
        return "cpu" if self.backend == "cpu" else None

    def resolve_trial_name(self) -> str:
        if not self.trial_name:
            import datetime

            self.trial_name = ("run" + datetime.datetime.now().strftime(
                "%Y%m%d-%H%M%S"))
        return self.trial_name


# ---------------- dotted overrides ----------------


def _field_map(obj) -> Dict[str, dataclasses.Field]:
    return {f.name: f for f in dataclasses.fields(obj)}


_HINT_CACHE: Dict[type, Dict[str, Any]] = {}


def _field_type(obj, name: str):
    """The resolved annotation of a field (``from __future__ import
    annotations`` stores strings)."""
    cls = type(obj)
    if cls not in _HINT_CACHE:
        try:
            _HINT_CACHE[cls] = typing.get_type_hints(cls)
        except Exception:  # noqa: BLE001 — unresolvable: per-field fallback
            _HINT_CACHE[cls] = {}
    return _HINT_CACHE[cls].get(name, _field_map(obj)[name].type)


def _strip_optional(tp):
    if typing.get_origin(tp) is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def _coerce(value: str, tp) -> Any:
    """Parse a command-line string into the annotated field type."""
    tp = _strip_optional(tp)
    if value.lower() in ("null", "none"):
        return None
    if tp is bool or tp == "bool":
        if value.lower() in ("1", "true", "yes", "on"):
            return True
        if value.lower() in ("0", "false", "no", "off"):
            return False
        raise ValueError(f"cannot parse bool from {value!r}")
    if tp is int or tp == "int":
        return int(value)
    if tp is float or tp == "float":
        return float(value)
    if tp is str or tp == "str":
        return value
    origin = typing.get_origin(tp)
    if origin in (list, List):
        if value.lstrip().startswith("["):
            # a JSON list: how a list of mappings (sentinel.rules) is given
            # without the reference's YAML
            return json.loads(value)
        (etp,) = typing.get_args(tp) or (str,)
        if not value:
            return []
        return [_coerce(v.strip(), etp) for v in value.split(",")]
    if origin in (dict, Dict):
        return json.loads(value)
    if tp is Any:
        try:
            return json.loads(value)
        except (ValueError, TypeError):
            return value
    raise ValueError(f"don't know how to parse {value!r} as {tp}")


class ConfigError(ValueError):
    pass


def _safe_set(obj, key: str, val):
    """setattr that tolerates frozen dataclasses; returns the object holding
    the assignment."""
    try:
        setattr(obj, key, val)
        return obj
    except dataclasses.FrozenInstanceError:
        return dataclasses.replace(obj, **{key: val})


def _unknown_key_msg(obj, key: str, path: str) -> str:
    names = [f.name for f in dataclasses.fields(obj)]
    close = difflib.get_close_matches(key, names, n=3)
    hint = f" (did you mean: {', '.join(close)}?)" if close else ""
    return (f"unknown config key '{path}' on {type(obj).__name__}{hint}; "
            f"valid keys: {', '.join(sorted(names))}")


def _assign(obj, parts: List[str], value: str, path: str):
    fm = _field_map(obj)
    key = parts[0]
    if key not in fm:
        raise ConfigError(_unknown_key_msg(obj, key, path))
    if len(parts) == 1:
        return _safe_set(obj, key, _coerce(value, _field_type(obj, key)))
    child = getattr(obj, key)
    if dataclasses.is_dataclass(child):
        return _safe_set(obj, key, _assign(child, parts[1:], value, path))
    if isinstance(child, dict):
        # a dict leaf: the rest of the path is one key, the value JSON
        child[".".join(parts[1:])] = _coerce(value, Any)
        return obj
    raise ConfigError(f"'{key}' is a leaf; cannot descend into '{path}'")


def apply_overrides(cfg, overrides: List[str]):
    """Apply ``a.b.c=value`` assignments in order. Mutates and returns
    ``cfg``."""
    for ov in overrides:
        if "=" not in ov:
            raise ConfigError(f"override {ov!r} is not of the form key=value")
        key, _, value = ov.partition("=")
        path = key.strip()
        if _assign(cfg, path.split("."), value.strip(), path) is not cfg:
            raise ConfigError(f"top-level config {type(cfg).__name__} must "
                              "not be frozen")
    return cfg


VALID_MODES = ("local", "slurm")
VALID_BACKENDS = ("cuda", "cpu")
VALID_RECOVER_MODES = ("disabled", "resume", "auto", "fault")

# MFC names the PPO experiment graph schedules (experiments/ppo_math_exp.py).
KNOWN_MFCS = ("actor_train", "actor_gen", "actor_inf", "critic_train",
              "critic_inf", "ref_inf", "rew_inf", "fused_rew_ref_inf")


def validate_config(cfg) -> None:
    """Checks at parse time, called after the overrides (training/_cli.py)
    and again by the launcher."""
    mode = getattr(cfg, "mode", "local")
    if mode not in VALID_MODES:
        raise ConfigError(f"mode={mode!r} is not supported by the port: "
                          f"valid modes are {', '.join(VALID_MODES)}")
    backend = getattr(cfg, "backend", "cuda")
    if backend not in VALID_BACKENDS:
        raise ConfigError(f"backend={backend!r}: valid backends are "
                          f"{', '.join(VALID_BACKENDS)}")
    recover = getattr(cfg, "recover_mode", "disabled")
    if recover not in VALID_RECOVER_MODES:
        raise ConfigError(f"recover_mode={recover!r}: valid modes are "
                          f"{', '.join(VALID_RECOVER_MODES)}")
    alloc_str = getattr(cfg, "allocation_mode", "") or ""
    if alloc_str:
        from areal_tpu_torch.parallel.mesh import AllocationMode

        try:
            alloc = AllocationMode.parse(alloc_str)
        except ValueError as e:
            raise ConfigError(
                f"invalid allocation_mode {alloc_str!r}: {e}") from None
        n_devices = (getattr(cfg, "n_nodes", 1)
                     * getattr(cfg, "n_gpus_per_node", 1))
        for mfc, spec in sorted(alloc.per_mfc.items()):
            if mfc not in KNOWN_MFCS:
                raise ConfigError(
                    f"allocation_mode names unknown MFC '{mfc}': known MFCs "
                    f"are {', '.join(KNOWN_MFCS)}")
        specs = [("global", alloc.global_spec), ("generation", alloc.gen_spec)]
        specs += [(f"MFC '{m}'", s) for m, s in sorted(alloc.per_mfc.items())]
        for label, spec in specs:
            if spec is not None and spec.world_size > n_devices:
                raise ConfigError(
                    f"allocation_mode {label} spec '{spec}' needs "
                    f"{spec.world_size} devices but the experiment has "
                    f"n_nodes×n_gpus_per_node = {n_devices}")
        _validate_ep(cfg, alloc)
        _validate_gen_spec(cfg, alloc)
    tiny = getattr(getattr(cfg, "actor", None), "tiny", None)
    moe = tiny.get("moe") if isinstance(tiny, dict) else None
    if isinstance(moe, dict):
        cf = float(moe.get("capacity_factor", 2.0))
        if cf <= 0:
            raise ConfigError(
                f"actor.tiny.moe.capacity_factor={cf} must be > 0: the "
                "expert buffer is ceil(top_k * tokens * capacity_factor "
                "/ num_experts) slots, and a non-positive factor drops "
                "every routed token (models/moe.py capacity).")
    _validate_serving(cfg)
    _validate_observability(cfg)
    _validate_reward_service(cfg)
    _validate_autoscale(cfg)
    _validate_durability(cfg)
    nr = getattr(getattr(cfg, "cluster", None), "name_resolve", None)
    if nr is not None and getattr(nr, "type", "nfs") not in ("nfs", "memory"):
        raise ConfigError(f"cluster.name_resolve.type={nr.type!r}: use nfs "
                          "(the default) or memory")


def _validate_ep(cfg, alloc) -> None:
    """The reference's three ``ep`` rules (cli_args.py:526-556): no ``ep``
    on a generation spec (decode never dispatches over owners), none on a
    dense model (no experts to shard), and experts that divide over it."""
    gen_specs = [("generation", alloc.gen_spec)]
    gen_specs += [(f"MFC '{m}'", s) for m, s in sorted(alloc.per_mfc.items())
                  if m == "actor_gen"]
    for label, spec in gen_specs:
        if spec is not None and spec.ep > 1:
            raise ConfigError(
                f"allocation_mode {label} spec '{spec}' sets ep={spec.ep}, "
                "but expert parallelism only applies to training: decode "
                "runs the grouped dispatch on whole experts (models/moe.py "
                "never exchanges under a KV cache). Move the ep factor into "
                "dp or tp for the generation fleet, e.g. e2 -> d2.")
    tiny = getattr(getattr(cfg, "actor", None), "tiny", None)
    moe = tiny.get("moe") if isinstance(tiny, dict) else None
    train_specs = [("global", alloc.global_spec)]
    train_specs += [(f"MFC '{m}'", s) for m, s in
                    sorted(alloc.per_mfc.items()) if m != "actor_gen"]
    for label, spec in train_specs:
        if spec is None or spec.ep <= 1:
            continue
        if not isinstance(moe, dict):
            raise ConfigError(
                f"allocation_mode {label} spec '{spec}' sets ep={spec.ep} "
                "but the model is dense (actor.tiny.moe is unset): there are "
                "no experts to shard. Drop the ep factor or configure "
                "actor.tiny.moe.")
        n_exp = int(moe.get("num_experts", 8))
        if n_exp % spec.ep:
            raise ConfigError(
                f"allocation_mode {label} spec '{spec}' sets ep={spec.ep}, "
                f"which does not divide actor.tiny.moe.num_experts={n_exp}: "
                "every ep rank must own the same number of experts.")


def _actor_geometry(cfg) -> Optional[tuple]:
    """(query heads, kv heads, layers) of the actor, from its tiny spec or
    its HF ``config.json``; None where neither says (a null model)."""
    actor = getattr(cfg, "actor", None)
    tiny = getattr(actor, "tiny", None)
    if isinstance(tiny, dict) and tiny:
        from areal_tpu_torch.models.config import tiny_config

        c = tiny_config(**{k: v for k, v in tiny.items() if k != "seed"})
        return c.n_q_heads, c.n_kv_heads, c.n_layers
    path = getattr(actor, "path", "") or ""
    if not path:
        return None
    try:
        with open(os.path.join(path, "config.json")) as f:
            c = json.load(f)
    except (OSError, ValueError):
        return None
    n_q = c.get("num_attention_heads")
    return ((n_q, c.get("num_key_value_heads") or n_q,
             c.get("num_hidden_layers")) if n_q else None)


def _validate_gen_spec(cfg, alloc) -> None:
    """A generation spec's servers: ``dp`` counts them, each a group of
    ``fsdp × pp × tp`` ranks (``parallel/mesh.py ServerRank``). ``sp`` is
    refused for the reference's reason (``ep`` by :func:`_validate_ep`);
    ``tp`` must split the actor's heads by the rules of
    ``parallel/sharding.py kv_replicated``, and ``pp`` give every stage a
    layer."""
    from areal_tpu_torch.parallel.mesh import (
        GEN_AXIS_REFUSALS,
        tp_kv_replicated,
    )

    gen_specs = [("generation", alloc.gen_spec)]
    gen_specs += [(f"MFC '{m}'", s) for m, s in sorted(alloc.per_mfc.items())
                  if m == "actor_gen"]
    for label, spec in gen_specs:
        if spec is None:
            continue
        if spec.sp > 1:
            raise ConfigError(
                f"allocation_mode {label} spec '{spec}' sets sp={spec.sp}, "
                f"but {GEN_AXIS_REFUSALS['sp']}.")
        geo = _actor_geometry(cfg)
        if geo is None:
            continue
        if spec.tp > 1:
            try:
                tp_kv_replicated(geo[0], geo[1], spec.tp)
            except ValueError as e:
                raise ConfigError(
                    f"allocation_mode {label} spec '{spec}': {e} (the "
                    f"actor has {geo[0]} query / {geo[1]} kv "
                    "heads)") from None
        if geo[2] is not None and spec.pp > geo[2]:
            raise ConfigError(
                f"allocation_mode {label} spec '{spec}' sets pp={spec.pp}, "
                f"more stages than the actor's {geo[2]} layers: a server's "
                "stage holds at least one layer.")


def _validate_serving(cfg) -> None:
    """The reference's serving checks: a bad bucket list fails here, not
    in every spawned server. ``experiment_policy_kwargs`` is the mapping
    the async experiment gives its servers, so this is the construction
    they will run."""
    serving = getattr(cfg, "serving", None)
    if not getattr(serving, "enabled", False):
        return
    from areal_tpu_torch.system.serving import (
        experiment_policy_kwargs,
        policy_from_config,
    )

    try:
        policy_from_config(serving, **experiment_policy_kwargs(cfg))
    except ValueError as e:
        raise ConfigError(f"invalid serving config: {e}") from None
    share = float(getattr(serving, "min_rollout_share", 0.0))
    if not 0.0 <= share <= 1.0:
        raise ConfigError(
            f"serving.min_rollout_share={share} must be in [0, 1] "
            f"(fraction of each batch reserved for rollout traffic)")


def _check_shape_budget(cfg) -> None:
    """With compile_watch and serving on, one shape budget covers both: the
    trainer's fill sweep may not mint more shapes than
    ``serving.max_compiled_shapes`` allows (reference cli_args.py:678)."""
    serving = getattr(cfg, "serving", None)
    if not getattr(serving, "enabled", False):
        return
    from areal_tpu_torch.backend.microbatch import worst_case_row_candidates

    max_shapes = int(getattr(serving, "max_compiled_shapes", 0))
    trainer_cands = worst_case_row_candidates()
    if 0 < max_shapes < trainer_cands:
        raise ConfigError(
            f"serving.max_compiled_shapes={max_shapes} is below "
            f"the trainer fill sweep's worst-case candidate count "
            f"({trainer_cands}, from backend/microbatch.py "
            f"worst_case_row_candidates): the trainer alone could "
            f"exceed the shape budget the serving policy enforces. "
            f"Raise serving.max_compiled_shapes to at least "
            f"{trainer_cands}, or coarsen the trainer's "
            f"fill_bucket (actor.backend fill_bucket) to shrink "
            f"the sweep.")


def _validate_observability(cfg) -> None:
    """The reference's checks of the goodput, compile_watch and sentinel
    blocks: each needs telemetry, and a bad rule pack fails here, naming
    the rule, not inside the spawned master."""
    tel_on = getattr(getattr(cfg, "telemetry", None), "enabled", False)
    for block in ("goodput", "compile_watch", "sentinel"):
        sub = getattr(cfg, block, None)
        if getattr(sub, "enabled", False) and not tel_on:
            raise ConfigError(
                f"{block}.enabled=true requires telemetry.enabled=true: it "
                "exports through the telemetry registry and the master's "
                "aggregator; without telemetry there is nowhere to export")
    gp = getattr(cfg, "goodput", None)
    if getattr(gp, "enabled", False):
        if gp.export_interval_secs <= 0:
            raise ConfigError(f"goodput.export_interval_secs="
                              f"{gp.export_interval_secs} must be > 0")
        if gp.peak_flops_override < 0:
            raise ConfigError(
                f"goodput.peak_flops_override={gp.peak_flops_override} "
                "must be >= 0 (0 = from the card's name)")
    cw = getattr(cfg, "compile_watch", None)
    if getattr(cw, "enabled", False):
        if cw.mem_sample_interval_secs < 0:
            raise ConfigError(f"compile_watch.mem_sample_interval_secs="
                              f"{cw.mem_sample_interval_secs} must be >= 0")
        _check_shape_budget(cfg)
    sn = getattr(cfg, "sentinel", None)
    if getattr(sn, "enabled", False):
        if sn.eval_interval_secs <= 0:
            raise ConfigError(f"sentinel.eval_interval_secs="
                              f"{sn.eval_interval_secs} must be > 0")
        from areal_tpu_torch.system.sentinel import rules_from_config

        try:
            rules_from_config(
                sn, durability_enabled=getattr(
                    getattr(cfg, "durability", None), "enabled", False),
                compile_watch_enabled=getattr(cw, "enabled", False))
        except ValueError as e:
            raise ConfigError(f"invalid sentinel rule pack: {e}") from None


def _validate_reward_service(cfg) -> None:
    """The reference's reward-service checks (cli_args.py:764)."""
    rs = getattr(cfg, "reward_service", None)
    if not getattr(rs, "enabled", False):
        return
    if rs.n_workers < 1:
        raise ConfigError(
            f"reward_service.n_workers={rs.n_workers} must be >= 1 (an "
            "enabled fleet needs at least one sandbox worker)")
    for knob in ("max_inflight", "pool_size", "max_concurrency"):
        if getattr(rs, knob) < 1:
            raise ConfigError(
                f"reward_service.{knob}={getattr(rs, knob)} must be >= 1")
    for knob in ("grade_timeout_secs", "request_timeout_secs"):
        if getattr(rs, knob) <= 0:
            raise ConfigError(
                f"reward_service.{knob}={getattr(rs, knob)} must be > 0 (a "
                "reward grade must have a finite wall budget)")
    if not rs.languages:
        raise ConfigError(
            "reward_service.languages is empty: an enabled fleet that "
            "grades no language returns 0.0 for every code task; list at "
            "least one of rewards/code_verify.py GRADERS (e.g. "
            "reward_service.languages=python)")
    from areal_tpu_torch.rewards.code_verify import GRADERS

    unknown = [lang for lang in rs.languages if lang not in GRADERS]
    if unknown:
        raise ConfigError(
            f"reward_service.languages={rs.languages}: no grader is "
            f"registered for {unknown} (available: "
            f"{', '.join(sorted(GRADERS))}; new languages register in "
            "rewards/code_verify.py GRADERS)")


def _validate_autoscale(cfg) -> None:
    """The reference's autoscale checks (cli_args.py:581)."""
    asc = getattr(cfg, "autoscale", None)
    if not getattr(asc, "enabled", False):
        return
    if asc.min_servers < 1:
        raise ConfigError(
            f"autoscale.min_servers={asc.min_servers} must be >= 1 (the "
            "fleet can never scale to zero routable servers)")
    if asc.max_servers < asc.min_servers:
        raise ConfigError(f"autoscale.max_servers={asc.max_servers} < "
                          f"min_servers={asc.min_servers}")
    if asc.interval_secs <= 0:
        raise ConfigError(
            f"autoscale.interval_secs={asc.interval_secs} must be > 0")
    if not 0.0 <= asc.down_utilization < asc.up_utilization:
        raise ConfigError(
            "autoscale utilization thresholds must satisfy 0 <= down "
            f"({asc.down_utilization}) < up ({asc.up_utilization}): equal "
            "or inverted thresholds make the fleet flap every interval")
    if asc.straggler_defense and asc.straggler_factor <= 1.0:
        raise ConfigError(
            f"autoscale.straggler_factor={asc.straggler_factor} must be > 1 "
            "(a server is only a straggler when it is slower than its "
            "peers)")


def _validate_durability(cfg) -> None:
    """The reference's durability checks (cli_args.py:740)."""
    dur = getattr(cfg, "durability", None)
    if not getattr(dur, "enabled", False):
        return
    if dur.spool_segment_bytes <= 0:
        raise ConfigError(f"durability.spool_segment_bytes="
                          f"{dur.spool_segment_bytes} must be > 0")
    if dur.spool_max_bytes < dur.spool_segment_bytes:
        raise ConfigError(
            f"durability.spool_max_bytes={dur.spool_max_bytes} < "
            f"spool_segment_bytes={dur.spool_segment_bytes}: the spool "
            "could never roll a full segment")
    if dur.resend_timeout_secs <= 0:
        raise ConfigError(
            f"durability.resend_timeout_secs={dur.resend_timeout_secs} "
            "must be > 0 (it is the only recovery path for a lost ack)")
    if dur.push_block_secs <= 0:
        raise ConfigError(
            f"durability.push_block_secs={dur.push_block_secs} must be > 0 "
            "(a zero budget fails every send)")


# ---------------- the YAML dump and load ----------------

def merge_dict(cfg, d: Dict[str, Any], _path: str = ""):
    """A (nested) plain dict, e.g. a parsed YAML file, merged onto a
    dataclass; unknown keys raise :class:`ConfigError` with the closest
    names (reference ``merge_dict:803``)."""
    fm = _field_map(cfg)
    for k, v in d.items():
        path = f"{_path}.{k}" if _path else k
        if k not in fm:
            raise ConfigError(_unknown_key_msg(cfg, k, path))
        cur = getattr(cfg, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            cfg = _safe_set(cfg, k, merge_dict(cur, v, path))
        elif isinstance(v, str) and not isinstance(cur, str) \
                and not dataclasses.is_dataclass(cur):
            cfg = _safe_set(cfg, k, _coerce(v, _field_type(cfg, k)))
        else:
            cfg = _safe_set(cfg, k, v)
    return cfg


def load_yaml(cfg, path: str):
    """Merge the YAML file ``path`` onto ``cfg`` (reference ``:821``). A
    JSON file (what :func:`save_yaml` writes where ``yaml`` is absent) is
    read with ``json``, with or without ``yaml``; anything else needs
    ``yaml``. A file that does not read raises :class:`ConfigError`."""
    with open(path) as f:
        text = f.read()
    try:
        d = json.loads(text) if text.strip() else {}
    except json.JSONDecodeError as e:
        try:
            import yaml
        except ImportError:
            raise ConfigError(
                f"{path} is not JSON and yaml is not installed to read it as "
                f"YAML: {e}") from None
        try:
            d = yaml.safe_load(text) or {}
        except yaml.YAMLError as e:
            raise ConfigError(f"{path} does not read as YAML: {e}") from None
    if not isinstance(d, dict):
        raise ConfigError(f"{path} holds a {type(d).__name__}, not a mapping "
                          "of config keys")
    return merge_dict(cfg, d)


def to_yaml_dict(cfg) -> Dict[str, Any]:
    """A dataclass as a plain dict that ``yaml.dump`` and ``json.dump`` both
    take: tuples become lists, anything else that is not a plain value its
    ``repr`` (reference ``:829``)."""
    def clean(x):
        if isinstance(x, dict):
            return {k: clean(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [clean(v) for v in x]
        if isinstance(x, (str, int, float, bool)) or x is None:
            return x
        return repr(x)

    return clean(dataclasses.asdict(cfg))


def save_yaml(cfg, path: str) -> None:
    """``cfg`` written to ``path`` as YAML (reference ``:844``), or as JSON
    where ``yaml`` is absent: JSON is a YAML document, so the file loads
    through :func:`load_yaml` either way."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    d = to_yaml_dict(cfg)
    try:
        import yaml
    except ImportError:
        text = json.dumps(d, indent=2) + "\n"
    else:
        text = yaml.dump(d, default_flow_style=False, sort_keys=False)
    with open(path, "w") as f:
        f.write(text)


def get_log_path(cfg) -> str:
    """The run's log directory, where the launcher dumps ``config.yaml``
    (the port's ``base/constants.experiment_paths`` layout)."""
    from areal_tpu_torch.base import constants

    return constants.experiment_paths(
        cfg.experiment_name, cfg.trial_name,
        fileroot=cfg.cluster.fileroot)["log"]


def print_config_help(cfg, _indent: int = 0) -> None:
    """The recursive ``--help`` printer (reference cli_args.py:1421)."""
    pad = "  " * _indent
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            print(f"{pad}{f.name}:  ({type(v).__name__})")
            print_config_help(v, _indent + 1)
        else:
            print(f"{pad}{f.name} = {v!r}")
