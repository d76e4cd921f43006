"""YAML run config (counterpart of ``alg_tpu/core/config.py``).

Same schema and merge semantics as the reference: sections
``model.{path,dtype[,flow_shift,flow_reverse]}``, ``generation``, ``alg`` and
``video``; pipeline kwargs are ``{**generation, **alg}`` with ``None`` values
dropped so the pipeline's defaults win; the model family is a substring of
``model.path``. ``yaml`` is imported when a file is loaded, so the package
imports without PyYAML, and :func:`run_config_from_dict` takes a config that
is already parsed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

_DTYPE_MAP = {
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float32": torch.float32,
    "float64": torch.float64,
}


def resolve_dtype(name: str) -> torch.dtype:
    """torch-dtype string -> ``torch.dtype``."""
    try:
        return _DTYPE_MAP[name]
    except KeyError:
        raise ValueError(f"Unsupported model dtype {name!r}; expected one of {sorted(_DTYPE_MAP)}")


@dataclasses.dataclass
class RunConfig:
    """Parsed YAML run config with reference merge semantics."""

    model_path: str
    model_dtype: torch.dtype
    model_dtype_str: str
    flow_shift: Optional[float]
    flow_reverse: Optional[bool]
    generation: Dict[str, Any]
    alg: Dict[str, Any]
    video: Dict[str, Any]
    raw: Dict[str, Any]

    @property
    def pipeline_kwargs(self) -> Dict[str, Any]:
        """``{**generation, **alg}`` with None dropped."""
        merged = {**self.generation, **self.alg}
        return {k: v for k, v in merged.items() if v is not None}

    @property
    def family(self) -> str:
        """The model family, by a substring of ``model.path``."""
        if "Wan" in self.model_path:
            return "wan"
        if "CogVideoX" in self.model_path:
            return "cogvideox"
        if "HunyuanVideo" in self.model_path:
            return "hunyuan"
        raise ValueError(f"Cannot infer model family from path {self.model_path!r}")


def load_run_config(path: str) -> RunConfig:
    """The YAML file at ``path`` as a :class:`RunConfig`."""
    import yaml

    with open(path, "r") as f:
        return run_config_from_dict(yaml.safe_load(f))


def run_config_from_dict(raw: Dict[str, Any]) -> RunConfig:
    """A parsed config (the YAML file's mapping) as a :class:`RunConfig`."""
    model = raw.get("model", {})
    dtype_str = model.get("dtype", "bfloat16")
    return RunConfig(
        model_path=model["path"],
        model_dtype=resolve_dtype(dtype_str),
        model_dtype_str=dtype_str,
        flow_shift=model.get("flow_shift"),
        flow_reverse=model.get("flow_reverse"),
        generation=dict(raw.get("generation") or {}),
        alg=dict(raw.get("alg") or {}),
        video=dict(raw.get("video") or {}),
        raw=raw,
    )
