"""Minimal Prometheus text-exposition parser / line-format checker (a copy
of mxnet_tpu/telemetry/promparse.py).

The inverse of :func:`exporters.prometheus_text`, kept deliberately
small: enough of the v0.0.4 grammar to (a) act as the conformance
checker the telemetry tests round-trip exposition output through, and
(b) let a tool read a remote replica's ``/metrics`` scrape without
depending on an external prometheus client. Strict by design: an unparseable line
raises :class:`ExpositionError` with the offending line — a scrape that
silently drops malformed series is exactly the bug the checker exists
to catch.

Stdlib only, like the rest of the telemetry package.
"""
from __future__ import annotations

import re

__all__ = ["ExpositionError", "parse_text", "sample_value", "CONTENT_TYPE"]

# what a conforming /metrics response advertises (exposition v0.0.4)
CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_NAME = r"[a-zA-Z_:][a-zA-Z0-9_:]*"
_LABEL = r"[a-zA-Z_][a-zA-Z0-9_]*"
_VALUE = r"(?:-?\d+(?:\.\d+)?(?:[eE][+-]?\d+)?|[+-]Inf|NaN)"

_SAMPLE_RE = re.compile(
    rf'^({_NAME})'
    rf'(\{{{_LABEL}="(?:[^"\\\n]|\\.)*"'
    rf'(?:,{_LABEL}="(?:[^"\\\n]|\\.)*")*,?\}})?'
    rf' ({_VALUE})(?: (-?\d+))?$')
_LABEL_RE = re.compile(rf'({_LABEL})="((?:[^"\\\n]|\\.)*)"')


class ExpositionError(ValueError):
    """A line that does not conform to the text exposition format."""


def _unescape(s):
    return (s.replace("\\\\", "\0").replace('\\"', '"')
            .replace("\\n", "\n").replace("\0", "\\"))


def _value(raw):
    if raw == "+Inf":
        return float("inf")
    if raw == "-Inf":
        return float("-inf")
    return float(raw)  # NaN parses as nan


def parse_text(text):
    """Parse exposition text into ``{family: {"type", "help", "samples"}}``.

    Each sample is ``{"name", "labels", "value"}`` — histogram
    ``_bucket``/``_sum``/``_count`` series land under their family name
    (the ``# TYPE`` declaration), like the scrape side of a real
    Prometheus. Raises :class:`ExpositionError` on any malformed line,
    a sample without a TYPE declaration, or a duplicate TYPE.
    """
    families = {}

    def family_of(name):
        if name in families:
            return name
        base = re.sub(r"_(bucket|sum|count)$", "", name)
        if base in families and families[base]["type"] == "histogram":
            return base
        return None

    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            parts = line[len("# HELP "):].split(" ", 1)
            name = parts[0]
            families.setdefault(
                name, {"type": "untyped", "help": "", "samples": []})
            families[name]["help"] = \
                _unescape(parts[1]) if len(parts) > 1 else ""
            continue
        if line.startswith("# TYPE "):
            parts = line[len("# TYPE "):].split(" ")
            if len(parts) != 2 or not re.fullmatch(_NAME, parts[0]):
                raise ExpositionError(f"malformed TYPE line: {line!r}")
            name, typ = parts
            if typ not in ("counter", "gauge", "histogram", "summary",
                           "untyped"):
                raise ExpositionError(f"unknown metric type in: {line!r}")
            fam = families.setdefault(
                name, {"type": "untyped", "help": "", "samples": []})
            if fam["samples"]:
                raise ExpositionError(
                    f"TYPE for {name!r} after its samples: {line!r}")
            if fam.get("_typed"):
                raise ExpositionError(f"duplicate TYPE for {name!r}")
            fam["type"], fam["_typed"] = typ, True
            continue
        if line.startswith("#"):
            continue  # free-form comment — legal, ignored
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ExpositionError(f"unparseable sample line: {line!r}")
        name, labelblock, raw = m.group(1), m.group(2), m.group(3)
        fam = family_of(name)
        if fam is None:
            raise ExpositionError(
                f"sample {name!r} has no TYPE declaration")
        labels = {}
        if labelblock:
            for lm in _LABEL_RE.finditer(labelblock):
                labels[lm.group(1)] = _unescape(lm.group(2))
        families[fam]["samples"].append(
            {"name": name, "labels": labels, "value": _value(raw)})
    for fam in families.values():
        fam.pop("_typed", None)
    return families


def sample_value(families, name, labels=None, default=None):
    """First sample value matching ``name`` (a family or series name)
    whose labels are a superset of ``labels``; ``default`` if absent."""
    labels = labels or {}
    fam = families.get(name)
    candidates = fam["samples"] if fam else [
        s for f in families.values() for s in f["samples"]
        if s["name"] == name]
    for s in candidates:
        if all(s["labels"].get(k) == str(v) for k, v in labels.items()):
            return s["value"]
    return default
