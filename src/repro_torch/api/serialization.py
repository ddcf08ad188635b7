"""Spec (de)serialization: dataclass ↔ dict ↔ TOML/JSON, content hashing.

The port's own copy of the JAX package's ``repro.api.serialization`` (the
port imports nothing of that package): the same dicts, TOML text and
content hashes, so one spec file hashes the same under both packages.

Generic machinery only — no knowledge of the concrete spec classes, so
:mod:`repro_torch.api.spec` can import this module without a cycle.  The rules
that make the round-trip lossless:

- ``to_plain_dict`` emits every field, including ``None``s, in dataclass
  field order (nested specs become nested dicts).
- ``from_plain_dict`` rejects unknown keys (typo safety), fills missing
  keys from the dataclass defaults, and coerces ints to floats where the
  field is float-typed (TOML/JSON writers drop trailing ``.0``s).
- TOML has no null, so the TOML writer *omits* ``None``-valued keys; every
  ``Optional`` spec field defaults to ``None``, so omission round-trips.

The TOML dialect is the flat subset the specs need — top-level scalars
plus one ``[table]`` per sub-spec, string/bool/int/float values.  Reading
prefers :mod:`tomllib` when the interpreter has it (3.11+) and falls back
to a small built-in parser of the same subset on 3.10.
"""
from typing import Union, get_args, get_origin

import contextlib
import dataclasses
import hashlib
import json

# ---------------------------------------------------------------------------
# dataclass ↔ plain dict
# ---------------------------------------------------------------------------


def to_plain_dict(obj) -> dict:
    """Dataclass instance → nested dict of primitives, in field order."""
    return dataclasses.asdict(obj)


def _optional_base(hint):
    """The payload type of ``Optional[T]`` (None if ``hint`` isn't one)."""
    if get_origin(hint) is Union:
        args = [a for a in get_args(hint) if a is not type(None)]
        if len(args) == 1 and len(get_args(hint)) == 2:
            return args[0]
    return None


def _coerce(hint, value, where: str):
    base = _optional_base(hint)
    if value is None:
        if base is not None:
            return None
        raise ValueError(f"{where} may not be null")
    if base is not None:
        hint = base
    if hint is float:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            raise ValueError(f"{where} must be a number, got {value!r}")
        return float(value)
    if hint is bool:
        if not isinstance(value, bool):
            raise ValueError(f"{where} must be a boolean, got {value!r}")
        return value
    if hint is int:
        if isinstance(value, bool) or not isinstance(value, int):
            raise ValueError(f"{where} must be an integer, got {value!r}")
        return value
    if hint is str:
        if not isinstance(value, str):
            raise ValueError(f"{where} must be a string, got {value!r}")
        return value
    raise TypeError(f"{where}: unsupported spec field type {hint!r}")


def from_plain_dict(cls, data: dict, where: str = "spec"):
    """Nested dict → ``cls`` instance (strict keys, light numeric coercion).

    Unknown keys raise (they are typos, not extensions); missing keys take
    the dataclass defaults, so hand-written TOML can stay minimal.
    """
    if not isinstance(data, dict):
        raise ValueError(f"{where} must be a table/dict, got {data!r}")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = sorted(set(data) - set(fields))
    if unknown:
        raise ValueError(
            f"{where} has unknown key(s) {unknown}; valid keys: "
            f"{sorted(fields)}"
        )
    kwargs = {}
    for name, value in data.items():
        f = fields[name]
        sub = f"{where}.{name}"
        if dataclasses.is_dataclass(f.type):
            kwargs[name] = from_plain_dict(f.type, value, where=sub)
        else:
            kwargs[name] = _coerce(f.type, value, where=sub)
    return cls(**kwargs)


# ---------------------------------------------------------------------------
# content hash
# ---------------------------------------------------------------------------


def content_hash(data: dict) -> str:
    """Stable 12-hex-digit digest of a plain dict.

    Canonical JSON (sorted keys, no whitespace) makes the hash a function
    of *content* only — reordering fields in a spec file, or round-tripping
    through TOML/JSON, never changes it.
    """
    blob = json.dumps(data, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


# ---------------------------------------------------------------------------
# TOML (flat subset: top-level scalars + one level of tables)
# ---------------------------------------------------------------------------


def _fmt_toml_value(v, where: str) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        r = repr(v)
        if "inf" in r or "nan" in r:
            raise ValueError(f"{where}: non-finite floats are not serializable")
        return r
    if isinstance(v, str):
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
    raise TypeError(f"{where}: cannot serialize {type(v).__name__} to TOML")


def toml_dumps(data: dict) -> str:
    """Nested dict (one table level) → TOML.  ``None`` values are omitted
    (TOML has no null; the spec reader treats absence as the default)."""
    lines = []
    tables = []
    for k, v in data.items():
        if isinstance(v, dict):
            tables.append((k, v))
        elif v is not None:
            lines.append(f"{k} = {_fmt_toml_value(v, k)}")
    for name, table in tables:
        lines.append("")
        lines.append(f"[{name}]")
        for k, v in table.items():
            if isinstance(v, dict):
                raise TypeError(f"{name}.{k}: specs nest only one table deep")
            if v is not None:
                lines.append(f"{k} = {_fmt_toml_value(v, f'{name}.{k}')}")
    return "\n".join(lines) + "\n"


def _parse_toml_scalar(s: str, where: str):
    if s.startswith('"'):
        out, i = [], 1
        while i < len(s):
            c = s[i]
            if c == "\\":
                if i + 1 >= len(s):
                    raise ValueError(f"{where}: dangling escape in {s!r}")
                out.append(s[i + 1])
                i += 2
                continue
            if c == '"':
                return "".join(out)
            out.append(c)
            i += 1
        raise ValueError(f"{where}: unterminated string {s!r}")
    s = s.split("#", 1)[0].strip()
    if s == "true":
        return True
    if s == "false":
        return False
    with contextlib.suppress(ValueError):
        return int(s)
    try:
        return float(s)
    except ValueError:
        raise ValueError(
            f"{where}: cannot parse value {s!r} (expected string/bool/"
            f"int/float)"
        ) from None


def toml_loads(text: str) -> dict:
    """Parse the flat TOML subset ``toml_dumps`` writes (stdlib
    :mod:`tomllib` when available, built-in fallback on 3.10)."""
    with contextlib.suppress(ModuleNotFoundError):
        import tomllib

        return tomllib.loads(text)
    out: dict = {}
    current = out
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        where = f"line {lineno}"
        if line.startswith("["):
            end = line.find("]")
            if end < 0:
                raise ValueError(f"{where}: malformed table header {line!r}")
            name = line[1:end].strip()
            if not name:
                raise ValueError(f"{where}: empty table name")
            current = out.setdefault(name, {})
            continue
        key, eq, value = line.partition("=")
        if not eq:
            raise ValueError(f"{where}: expected 'key = value', got {line!r}")
        current[key.strip()] = _parse_toml_scalar(value.strip(), where)
    return out


# ---------------------------------------------------------------------------
# dotted-path overrides ("engine.kind=async")
# ---------------------------------------------------------------------------


def parse_override(item: str):
    """``"engine.kind=async"`` → ``("engine.kind", "async")``."""
    path, eq, value = item.partition("=")
    if not eq or not path.strip():
        raise ValueError(
            f"override must look like section.key=value, got {item!r}"
        )
    return path.strip(), value.strip()


def _coerce_override_str(hint, raw: str, where: str):
    base = _optional_base(hint)
    if base is not None and raw.lower() in ("none", "null", ""):
        return None
    target = base if base is not None else hint
    if target is bool:
        if raw.lower() in ("true", "1", "yes"):
            return True
        if raw.lower() in ("false", "0", "no"):
            return False
        raise ValueError(f"{where}: expected a boolean, got {raw!r}")
    if target is int:
        try:
            return int(raw)
        except ValueError:
            raise ValueError(f"{where}: expected an integer, got {raw!r}") from None
    if target is float:
        try:
            return float(raw)
        except ValueError:
            raise ValueError(f"{where}: expected a number, got {raw!r}") from None
    if raw and raw[0] == raw[-1] == '"' and len(raw) >= 2:
        raw = raw[1:-1]
    return raw


def set_dotted(cls, data: dict, path: str, value, *, parse_str: bool):
    """Set ``path`` (e.g. ``"engine.kind"``) in the plain dict ``data``,
    coercing ``value`` by the dataclass field type along the way.

    ``parse_str=True`` treats ``value`` as CLI text (``--set`` semantics:
    "none" → null, "true"/"false" → bool, numerics parsed); ``False``
    expects an already-typed value (flag aliases).
    """
    parts = path.split(".")
    node, here = data, cls
    for head in parts[:-1]:
        fields = {f.name: f for f in dataclasses.fields(here)}
        if head not in fields or not dataclasses.is_dataclass(fields[head].type):
            raise ValueError(f"unknown spec section {head!r} in {path!r}")
        node = node.setdefault(head, {})
        here = fields[head].type
    leaf = parts[-1]
    fields = {f.name: f for f in dataclasses.fields(here)}
    if leaf not in fields:
        raise ValueError(
            f"unknown spec field {path!r}; {here.__name__} has "
            f"{sorted(fields)}"
        )
    hint = fields[leaf].type
    if dataclasses.is_dataclass(hint):
        raise ValueError(f"{path!r} is a section, not a field")
    if parse_str:
        value = _coerce_override_str(hint, str(value), path)
    else:
        value = _coerce(hint, value, path)
    node[leaf] = value
