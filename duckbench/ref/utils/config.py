"""Nested config with attribute access and flattened-key overrides.

Stands in for ``ml_collections.ConfigDict`` as the JAX package uses it: the
same keys, read as attributes (``cfg.noise_config.scales.gyro``), and
``update_from_flattened_dict({"noise_config.level": 0.0})`` that replaces
existing keys only, as a locked ConfigDict does.
"""

from __future__ import annotations

from typing import Any, Dict


class Config(dict):
    """A dict whose keys are also attributes; nested dicts become Configs."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for k, v in self.items():
            if isinstance(v, dict) and not isinstance(v, Config):
                self[k] = Config(v)

    def __getattr__(self, k: str) -> Any:
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def update_from_flattened_dict(self, flat: Dict[str, Any]) -> None:
        """Set dotted keys; a key not in the config raises KeyError."""
        for key, value in flat.items():
            node = self
            *parents, leaf = key.split(".")
            for p in parents:
                node = node[p]
                if not isinstance(node, Config):
                    raise KeyError(key)
            if leaf not in node:
                raise KeyError(key)
            node[leaf] = Config(value) if isinstance(value, dict) else value
