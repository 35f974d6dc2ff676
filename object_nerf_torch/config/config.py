"""Layered YAML configuration with dotted CLI overrides.

Counterpart of `object_nerf_tpu/config/config.py`, with `yaml` imported
only where a file or a CLI value is parsed, so the package imports
without PyYAML installed.

Reproduces the public config UX of the reference (train.py:275-286):
`default_conf.yml < dataset yaml < CLI dot-list`, with
attribute access (`cfg.model.N_samples`) and `get()` with defaults —
without depending on omegaconf.

CLI values are parsed as YAML, so `img_wh=[640,480]`, `lr=1e-3`,
`use_bbox=false` all coerce to the right types.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Any, Mapping


class Config(dict):
    """A nested dict with attribute access and deep merge.

    Nested mappings are converted to `Config` recursively on insertion, so
    `cfg.model.N_samples` works at any depth.
    """

    def __init__(self, data: Mapping[str, Any] | None = None):
        super().__init__()
        if data:
            for k, v in data.items():
                self[k] = v

    # -- conversion ---------------------------------------------------------
    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, Config):
            return value
        if isinstance(value, Mapping):
            return Config(value)
        if isinstance(value, list):
            return [Config._wrap(v) for v in value]
        return value

    def __setitem__(self, key: str, value: Any) -> None:
        super().__setitem__(key, Config._wrap(value))

    # -- attribute access ---------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    # -- deep merge ---------------------------------------------------------
    def merge(self, other: Mapping[str, Any]) -> "Config":
        """Deep-merge `other` into self (other wins). Returns self."""
        for k, v in other.items():
            if (
                k in self
                and isinstance(self[k], Config)
                and isinstance(v, Mapping)
            ):
                self[k].merge(v)
            else:
                self[k] = copy.deepcopy(v) if isinstance(v, (dict, list)) else v
        return self

    # -- dotted access ------------------------------------------------------
    def set_dotted(self, dotted_key: str, value: Any) -> None:
        node = self
        parts = dotted_key.split(".")
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], Config):
                node[p] = Config()
            node = node[p]
        node[parts[-1]] = value

    # -- (de)serialization --------------------------------------------------
    def to_dict(self) -> dict:
        def unwrap(v):
            if isinstance(v, Config):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, list):
                return [unwrap(x) for x in v]
            return v

        return unwrap(self)

    def to_yaml(self) -> str:
        import yaml

        return yaml.safe_dump(self.to_dict(), sort_keys=False)

    def save(self, path: str | Path) -> None:
        Path(path).write_text(self.to_yaml())

    @classmethod
    def from_yaml(cls, path: str | Path) -> "Config":
        import yaml

        data = yaml.safe_load(Path(path).read_text())
        return cls(data or {})

    @classmethod
    def from_dotlist(cls, args: list[str]) -> "Config":
        """Parse `key.sub=value` CLI arguments; values are YAML-coerced."""
        import yaml

        cfg = cls()
        for arg in args:
            if "=" not in arg:
                raise ValueError(f"CLI override must be key=value, got {arg!r}")
            key, _, raw = arg.partition("=")
            try:
                value = yaml.safe_load(raw) if raw != "" else None
            except yaml.YAMLError:
                value = raw
            if isinstance(value, str):
                # YAML 1.1 misses bare scientific notation like `1e-3`
                try:
                    value = int(value)
                except ValueError:
                    try:
                        value = float(value)
                    except ValueError:
                        pass
            cfg.set_dotted(key.strip(), value)
        return cfg


_DEFAULT_CONF = Path(__file__).parent / "defaults" / "default_conf.yml"


def load_config(
    dataset_config: str | Path | None = None,
    cli_args: list[str] | None = None,
    default_conf: str | Path | None = None,
) -> Config:
    """Three-layer merge: default_conf < dataset yaml < CLI dot-list.

    Mirrors the reference CLI contract (train.py:276-280): if the CLI list
    contains `dataset_config=...`, that file is loaded as the middle layer.
    """
    cli = Config.from_dotlist(cli_args or [])
    if dataset_config is None and "dataset_config" in cli:
        dataset_config = cli["dataset_config"]
    cfg = Config.from_yaml(default_conf or _DEFAULT_CONF)
    if dataset_config is not None:
        cfg.merge(Config.from_yaml(dataset_config))
    cfg.merge(cli)
    return cfg

