"""Global-model versioning (counterpart of ``nanofed_tpu/persistence/model_manager.py``).

Each saved version is ``models/model_v_<timestamp>_<counter>.npz`` (the JAX package's
npz layout, ``persistence.serialization``) with a JSON sidecar
``configs/model_v_<timestamp>_<counter>.json``, so a directory of either package is
listed, loaded and extended by the other: the counter resumes past every version
already there, and the listing skips torn or foreign JSON.  ``load_model`` returns
flat params on the CPU; ``like=`` checks names, shapes and dtypes.
"""

from __future__ import annotations

import json
from datetime import datetime, timezone
from pathlib import Path
from typing import Any

import numpy as np

from nanofed_tpu_torch.core.exceptions import ModelManagerError
from nanofed_tpu_torch.core.types import ModelVersion, Params
from nanofed_tpu_torch.persistence.serialization import load_pytree_npz, save_pytree_npz
from nanofed_tpu_torch.utils.logger import Logger, log_exec
from nanofed_tpu_torch.utils.trees import tree_size


def make_json_serializable(obj: Any) -> Any:
    """Best-effort conversion of metadata to JSON types."""
    if isinstance(obj, dict):
        return {str(k): make_json_serializable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [make_json_serializable(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if hasattr(obj, "item") and getattr(obj, "ndim", None) == 0:  # 0-d tensor
        return obj.item()
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return str(obj)


class ModelManager:
    """Versioned persistence of the global model.

    Directory layout (the JAX package's)::

        base_dir/
          models/   model_v_<ts>_<counter>.npz
          configs/  model_v_<ts>_<counter>.json
    """

    def __init__(self, base_dir: str | Path) -> None:
        self.base_dir = Path(base_dir)
        self.models_dir = self.base_dir / "models"
        self.configs_dir = self.base_dir / "configs"
        self.models_dir.mkdir(parents=True, exist_ok=True)
        self.configs_dir.mkdir(parents=True, exist_ok=True)
        self._counter = self._initial_counter()
        self._log = Logger()

    def _initial_counter(self) -> int:
        # Resume the counter past any existing versions so ids never collide.
        highest = 0
        for p in self.configs_dir.glob("model_v_*.json"):
            try:
                highest = max(highest, int(p.stem.rsplit("_", 1)[-1]))
            except ValueError:
                continue
        return highest

    @log_exec
    def save_model(self, params: Params, metadata: dict[str, Any] | None = None) -> ModelVersion:
        """Persist ``params`` as a new version (weights file plus a JSON sidecar
        carrying round id and metrics); returns its ``ModelVersion`` record."""
        self._counter += 1
        now = datetime.now(timezone.utc)
        version_id = f"model_v_{now.strftime('%Y%m%d_%H%M%S')}_{self._counter:04d}"
        model_path = self.models_dir / f"{version_id}.npz"
        config_path = self.configs_dir / f"{version_id}.json"

        save_pytree_npz(model_path, params)
        meta = make_json_serializable(metadata or {})
        config = {
            "version_id": version_id,
            "created_at": now.isoformat(),
            "counter": self._counter,
            "num_parameters": int(tree_size(params)),
            "metadata": meta,
        }
        tmp = config_path.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(config, indent=2))
        tmp.replace(config_path)
        self._log.debug("saved model version %s", version_id)
        return ModelVersion(
            version_id=version_id,
            created_at=now,
            model_path=str(model_path),
            config_path=str(config_path),
            round_number=int(meta.get("round", -1)) if isinstance(meta, dict) else -1,
        )

    @log_exec
    def load_model(
        self, version_id: str | None = None, like: Params | None = None
    ) -> tuple[Params, ModelVersion]:
        """Load a specific version, or the latest when ``version_id`` is None, as
        flat params on the CPU; ``like=`` (e.g. the live params) checks names,
        shapes and dtypes."""
        if version_id is None:
            versions = self.list_versions()
            if not versions:
                raise ModelManagerError(f"no saved model versions under {self.base_dir}")
            version = versions[-1]
        else:
            version = self._read_version(self.configs_dir / f"{version_id}.json")
        params = load_pytree_npz(version.model_path, like=like)
        return params, version

    def list_versions(self) -> list[ModelVersion]:
        """All saved versions, oldest first."""
        versions = []
        for p in sorted(self.configs_dir.glob("model_v_*.json")):
            try:
                versions.append(self._read_version(p))
            except ModelManagerError:
                continue  # skip torn/foreign files rather than failing the listing
        versions.sort(key=lambda v: (v.created_at, v.version_id))
        return versions

    def _read_version(self, config_path: Path) -> ModelVersion:
        if not config_path.exists():
            raise ModelManagerError(f"model version config not found: {config_path}")
        try:
            config = json.loads(config_path.read_text())
            version_id = config["version_id"]
            created_at = datetime.fromisoformat(config["created_at"])
            meta = config.get("metadata", {})
            round_number = int(meta.get("round", -1)) if isinstance(meta, dict) else -1
        except (json.JSONDecodeError, KeyError, ValueError, TypeError, AttributeError) as e:
            raise ModelManagerError(f"corrupt version config {config_path}: {e}") from e
        return ModelVersion(
            version_id=version_id,
            created_at=created_at,
            model_path=str(self.models_dir / f"{version_id}.npz"),
            config_path=str(config_path),
            round_number=round_number,
        )
