"""The trainer worker — for now only its weight-publish half.

Counterpart of ``areal_tpu/system/trainer_worker.py``'s ``_save_role:683``
(its ``fmt="native"`` case), ``_compute_dtype_params:701``, ``publish_weights:720``
(disk), ``_publish_weights_stream:765``, ``_clear_stale_transport_keys:866``
and ``_bump_version:884``, under the same names. A ``TrainerWorker`` holds
the role → ``Model`` map and publishes a role's weights in its engine's
compute dtype, at the version ``model.version.global_step``:

 - ``disk`` writes a native checkpoint (``models/hf.py
   save_native_checkpoint``) under ``realloc_dir/<role>/<version>``;
 - ``stream`` hands the tensors to the role's ``WeightStreamPublisher``,
   which serves them from its host cache.

Either way ``names.model_version_time`` (publish start, the anchor of the
weight-sync latency) and ``names.model_version`` are set, and the other
transport's discovery key is deleted. The request/reply fabric, the model
functions' dispatch, telemetry and the ``device`` transport wait for later
slices.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import tempfile
import time
from typing import Dict, Optional

import torch

from areal_tpu_torch.api.model import Model
from areal_tpu_torch.api.train_config import WeightSyncConfig
from areal_tpu_torch.base import name_resolve, names
from areal_tpu_torch.models import convert, hf
from areal_tpu_torch.system.weight_stream import WeightStreamPublisher

logger = logging.getLogger("areal_tpu_torch.trainer_worker")


@dataclasses.dataclass
class TrainerWorkerConfig:
    experiment: str = "exp"
    trial: str = "trial"
    realloc_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "areal_tpu", "realloc"))
    weight_sync: WeightSyncConfig = dataclasses.field(
        default_factory=WeightSyncConfig)


class TrainerWorker:
    def __init__(self, cfg: TrainerWorkerConfig,
                 models: Optional[Dict[str, Model]] = None):
        self.cfg = cfg
        self.models: Dict[str, Model] = dict(models or {})
        self._weight_publishers: Dict[str, WeightStreamPublisher] = {}

    def _save_role(self, role: str, path: str) -> int:
        """The role's weights under ``path`` in the native weight-sync
        layout and the compute dtype (the reference's ``fmt="native"``; its
        HF-format save hooks come with the rest of the worker). Returns the
        bytes written."""
        model = self.models[role]
        return hf.save_native_checkpoint(
            self._compute_dtype_params(role), model.module.cfg, path,
            meta={"version": model.version.global_step})

    @torch.no_grad()
    def _compute_dtype_params(self, role: str) -> Dict[str, torch.Tensor]:
        """The role's parameters cast (on their device) to the engine's
        compute dtype: weight-sync payloads travel in it, halving the bytes
        of f32 masters in bf16. Every tensor is a copy this call owns: the
        optimizer updates the masters in place, so where the cast returns
        the master itself (an f32 compute dtype, or an inference engine's
        own dtype) it is cloned."""
        engine = self.models[role].module
        cd = engine.compute_dtype
        out = {}
        for name, p in engine.params.items():
            p = p.detach()
            t = p.to(cd) if p.is_floating_point() else p
            out[name] = t.clone() if t.data_ptr() == p.data_ptr() else t
        return out

    def publish_weights(self, role: str) -> None:
        """Make the role's weights visible to the generation servers and
        bump ``names.model_version``, over ``weight_sync.transport``."""
        transport = self.cfg.weight_sync.transport
        if transport == "stream":
            self._publish_weights_stream(role)
            return
        if transport != "disk":
            raise ValueError(f"unknown weight_sync.transport {transport!r}")
        version = self.models[role].version.global_step
        path = os.path.join(self.cfg.realloc_dir, role, str(version))
        t0 = time.monotonic()
        self._save_role(role, path)
        save_secs = time.monotonic() - t0
        # A stream-mode predecessor may have left its endpoint behind.
        self._clear_stale_transport_keys(role, keep="disk")
        self._bump_version(role, version, save_secs)
        logger.info(f"published {role} weights v{version} -> {path} "
                    f"(save {save_secs:.2f}s)")

    def _publish_weights_stream(self, role: str) -> None:
        model = self.models[role]
        version = model.version.global_step
        t0 = time.monotonic()
        flat = convert.params_to_reference(self._compute_dtype_params(role),
                                           model.module.cfg)
        pub = self._weight_publishers.get(role)
        if pub is None:
            pub = WeightStreamPublisher(
                self.cfg.experiment, self.cfg.trial, role,
                chunk_bytes=self.cfg.weight_sync.chunk_mb << 20)
            self._weight_publishers[role] = pub
        # publish() returns once the manifest is registered; the d2h gather
        # runs in the publisher's thread, overlapping the wire leg.
        pub.publish(sorted(flat.items()), version)
        publish_secs = time.monotonic() - t0
        self._clear_stale_transport_keys(role, keep="stream")
        self._bump_version(role, version, publish_secs)
        logger.info(f"published {role} weights v{version} -> {pub.endpoint} "
                    f"(stream publish {publish_secs:.2f}s; the gather "
                    "continues in the background)")

    def _clear_stale_transport_keys(self, role: str, keep: str) -> None:
        """Drop the other transports' discovery keys, so nothing steers a
        server at a transport this trainer does not publish on."""
        stale = {"stream": names.weight_stream, "device": names.weight_device}
        stale.pop(keep, None)
        for key in stale.values():
            try:
                name_resolve.delete(key(self.cfg.experiment, self.cfg.trial,
                                        role))
            except name_resolve.NameEntryNotFoundError:
                pass

    def _bump_version(self, role: str, version: int,
                      publish_secs: float) -> None:
        # The publish start anchors the end-to-end weight-sync latency
        # (publish start → the servers serve the new version).
        name_resolve.add(
            names.model_version_time(self.cfg.experiment, self.cfg.trial, role),
            repr(time.time() - publish_secs), replace=True)
        name_resolve.add(
            names.model_version(self.cfg.experiment, self.cfg.trial, role),
            str(version), replace=True)

    def close(self) -> None:
        """Stop every weight-stream publisher (their keys are deleted)."""
        for pub in self._weight_publishers.values():
            pub.close()
        self._weight_publishers.clear()
