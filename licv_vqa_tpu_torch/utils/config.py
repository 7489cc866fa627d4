"""Native Hydra-compatible config composition.

The reference drives everything through Hydra 1.3 config groups with CLI
``key=val`` overrides and OmegaConf ``${...}`` interpolation (reference:
train.py:29, config/train.yaml, SURVEY.md §5.6).  Hydra/OmegaConf are not in
this image, so we implement the subset the config tree actually uses:

- ``defaults:`` lists with ``_self_``, ``group: option``, same-group bases
  (``- lmm_base``), and interpolated group choices (``- prompt:
  ${lmm}_${data_cfg/task}`` — resolves to the *selected option names*);
- CLI overrides: ``a.b.c=val`` value overrides and ``group=option`` group
  swaps (plus ``+key=val`` additions);
- interpolations: ``${oc.env:VAR}``, ``${oc.env:VAR,default}`` and absolute
  ``${path.to.key}`` — resolved lazily on access, matching OmegaConf's lazy
  semantics (the reference relies on this: config/inference.yaml:22
  interpolates a group that is never composed and is only safe lazily).

YAML files compose the same way as the reference's ``config/`` tree, so the
reference's documented run recipes work verbatim against our ``train.py`` /
``inference.py``.
"""

from __future__ import annotations

import copy
import os
import re
from pathlib import Path
from typing import Any, Iterator, Mapping

import yaml

_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")


class _YamlLoader(yaml.SafeLoader):
    """SafeLoader + OmegaConf-style float parsing (``1e-6`` is a float)."""


_YamlLoader.add_implicit_resolver(
    "tag:yaml.org,2002:float",
    re.compile(
        r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
        |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
        |\.[0-9_]+(?:[eE][-+][0-9]+)?
        |[-+]?\.(?:inf|Inf|INF)
        |\.(?:nan|NaN|NAN))$""",
        re.X,
    ),
    list("-+0123456789."),
)


class InterpolationError(KeyError):
    pass


def load_yaml(path: str | Path) -> dict:
    with open(path) as f:
        out = yaml.load(f, Loader=_YamlLoader)
    return out or {}


class Config(Mapping):
    """Attribute/dict hybrid view over a nested dict with lazy interpolation.

    Mirrors the parts of ``omegaconf.DictConfig`` used by the reference:
    attribute access, ``get``, ``in``, iteration, and ``${...}`` resolution at
    access time (never at compose time).
    """

    def __init__(self, data: dict, root: "Config" | None = None):
        object.__setattr__(self, "_data", data)
        object.__setattr__(self, "_root", root if root is not None else self)

    # -- raw access -------------------------------------------------------
    @property
    def raw(self) -> dict:
        return self._data

    def _wrap(self, value: Any) -> Any:
        if isinstance(value, dict):
            return Config(value, root=self._root)
        if isinstance(value, str):
            return self._resolve_str(value)
        if isinstance(value, list):
            return [self._wrap(v) for v in value]
        return value

    def _resolve_str(self, s: str, _depth: int = 0) -> Any:
        if _depth > 16:
            raise InterpolationError(f"interpolation loop resolving {s!r}")
        m = _INTERP_RE.fullmatch(s)
        if m:  # whole-string interpolation keeps the value's type
            return self._resolve_ref(m.group(1), _depth)

        def sub(match: re.Match) -> str:
            return str(self._resolve_ref(match.group(1), _depth))

        return _INTERP_RE.sub(sub, s) if "${" in s else s

    def _resolve_ref(self, ref: str, _depth: int) -> Any:
        if ref.startswith("oc.env:"):
            spec = ref[len("oc.env:") :]
            name, _, default = spec.partition(",")
            val = os.environ.get(name.strip())
            if val is None:
                if _ := default:
                    return default.strip()
                raise InterpolationError(f"environment variable {name!r} not set")
            return val
        node: Any = self._root
        for part in ref.split("."):
            if isinstance(node, Config):
                node = node._data
            if not isinstance(node, dict) or part not in node:
                raise InterpolationError(f"interpolation key {ref!r} not found")
            node = node[part]
        if isinstance(node, str):
            return self._root._resolve_str(node, _depth + 1)
        if isinstance(node, dict):
            return Config(node, root=self._root)
        return node

    # -- mapping protocol ---------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._wrap(self._data[key])

    def __getattr__(self, key: str) -> Any:
        if key not in self._data:
            raise AttributeError(key)
        return self._wrap(self._data[key])

    def __setattr__(self, key: str, value: Any) -> None:
        self._data[key] = value.raw if isinstance(value, Config) else value

    __setitem__ = __setattr__

    def __contains__(self, key: object) -> bool:
        return key in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def get(self, key: str, default: Any = None) -> Any:
        if key in self._data:
            return self._wrap(self._data[key])
        return default

    def keys(self):
        return self._data.keys()

    def to_dict(self, resolve: bool = True) -> dict:
        """Deep plain-dict copy; resolves interpolations when ``resolve``."""
        if not resolve:
            return copy.deepcopy(self._data)

        def rec(node: Any) -> Any:
            if isinstance(node, Config):
                return {k: rec(node[k]) for k in node}
            if isinstance(node, list):
                return [rec(v) for v in node]
            return node

        return rec(self)

    def __repr__(self) -> str:
        return f"Config({self._data!r})"


# ---------------------------------------------------------------------------
# Composition
# ---------------------------------------------------------------------------


def _deep_merge(dst: dict, src: dict) -> dict:
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_merge(dst[k], v)
        else:
            dst[k] = copy.deepcopy(v)
    return dst


def _set_dotted(d: dict, dotted: str, value: Any) -> None:
    parts = dotted.split(".")
    for p in parts[:-1]:
        d = d.setdefault(p, {})
    d[parts[-1]] = value


def _del_dotted(d: dict, dotted: str) -> None:
    parts = dotted.split(".")
    for p in parts[:-1]:
        if not isinstance(d, dict) or p not in d:
            raise KeyError(f"cannot delete {dotted!r}: {p!r} not in config")
        d = d[p]
    if not isinstance(d, dict) or parts[-1] not in d:
        raise KeyError(f"cannot delete {dotted!r}: key not in config")
    del d[parts[-1]]


def _parse_value(s: str) -> Any:
    try:
        return yaml.load(s, Loader=_YamlLoader)
    except yaml.YAMLError:
        return s


def _resolve_choice_interp(option: str, choices: dict[str, str]) -> str:
    """Resolve ``${group}`` / ``${group/sub}`` in a defaults-list option name
    against the *selected option names* (Hydra defaults-list semantics)."""

    def sub(m: re.Match) -> str:
        key = m.group(1)
        if key not in choices:
            raise InterpolationError(
                f"defaults interpolation {key!r} has no selected option"
            )
        return choices[key]

    return _INTERP_RE.sub(sub, option)


def _compose_node(
    config_dir: Path,
    group: str,  # "" for primary; "data_cfg/task" style otherwise
    option: str,
    choices: dict[str, str],
    group_overrides: dict[str, str],
) -> dict:
    path = config_dir / group / f"{option}.yaml"
    if not path.exists() and path.with_suffix(".yml").exists():
        path = path.with_suffix(".yml")
    raw = load_yaml(path)
    defaults = raw.pop("defaults", None)
    node: dict = {}
    merged_self = False

    if defaults is None:
        defaults = ["_self_"]
    if "_self_" not in defaults:
        defaults = list(defaults) + ["_self_"]

    for entry in defaults:
        if entry == "_self_":
            _deep_merge(node, raw)
            merged_self = True
            continue
        if isinstance(entry, str):
            # same-group base file, e.g. `- lmm_base` inside lmm/idefics-9B.yaml
            base = _compose_node(config_dir, group, entry, choices, group_overrides)
            _deep_merge(node, base)
            continue
        if isinstance(entry, dict):
            ((sub_group, sub_option),) = entry.items()
            full_group = f"{group}/{sub_group}" if group else sub_group
            sub_option = group_overrides.get(
                full_group, _resolve_choice_interp(str(sub_option), choices)
            )
            choices[full_group] = sub_option
            sub_node = _compose_node(
                config_dir, full_group, sub_option, choices, group_overrides
            )
            # place at the group's path relative to this node
            target = node
            parts = sub_group.split("/")
            for p in parts[:-1]:
                target = target.setdefault(p, {})
            existing = target.get(parts[-1])
            if isinstance(existing, dict):
                _deep_merge(existing, sub_node)
            else:
                target[parts[-1]] = sub_node
            continue
        raise ValueError(f"unsupported defaults entry: {entry!r}")

    if not merged_self:
        _deep_merge(node, raw)
    return node


def compose(
    config_dir: str | Path,
    config_name: str,
    overrides: list[str] | None = None,
) -> Config:
    """Compose ``config_dir/config_name`` with Hydra-style CLI overrides."""
    config_dir = Path(config_dir)
    config_name = config_name.removesuffix(".yaml").removesuffix(".yml")
    overrides = list(overrides or [])

    group_overrides: dict[str, str] = {}
    value_overrides: list[tuple[str, Any]] = []
    additive_groups: list[tuple[str, str]] = []
    deletes: list[str] = []
    for ov in overrides:
        if ov.startswith("~"):
            # Hydra delete syntax: `~key` or `~key=value`
            deletes.append(ov[1:].partition("=")[0])
            continue
        if "=" not in ov:
            raise ValueError(f"override {ov!r} must be key=value")
        key, _, val = ov.partition("=")
        additive = key.startswith("+")
        key = key.lstrip("+")
        # A group override is `path/with/slashes=opt` or a bare group name that
        # has a matching config directory.
        gpath = key.replace(".", "/")
        if (config_dir / gpath).is_dir():
            if additive:
                # Hydra `+group=option`: ADD a group absent from the defaults
                # list by composing config/<group>/<option>.yaml — NOT a
                # literal value set (that would leave e.g. cfg.lmm a string)
                additive_groups.append((gpath, val))
            else:
                group_overrides[gpath] = val
        else:
            # plain and `+`/`++` value overrides all set the key (deliberate
            # permissive deviation: Hydra errors on key=val for absent keys)
            value_overrides.append((key, _parse_value(val)))

    choices: dict[str, str] = dict(group_overrides)
    tree = _compose_node(config_dir, "", config_name, choices, group_overrides)
    tree.pop("hydra", None)  # run-dir management is handled by our CLIs
    for gpath, opt in additive_groups:
        choices[gpath] = opt
        sub = _compose_node(config_dir, gpath, opt, choices, group_overrides)
        target = tree
        parts = gpath.split("/")
        for p in parts[:-1]:
            target = target.setdefault(p, {})
        existing = target.get(parts[-1])
        if isinstance(existing, dict) and isinstance(sub, dict):
            _deep_merge(existing, sub)
        else:
            target[parts[-1]] = sub
    for key, val in value_overrides:
        _set_dotted(tree, key, val)
    for key in deletes:
        _del_dotted(tree, key)
    return Config(tree)
