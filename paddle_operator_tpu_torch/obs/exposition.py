"""Prometheus text-exposition helpers of the port: its copies of
``http_respond``, ``format_value`` and the strict validator
``parse_exposition`` of ``paddle_operator_tpu/obs/exposition.py``, and of
``escape_label_value`` and ``fold_suffix`` of
``paddle_operator_tpu/k8s/runtime.py``. The worker ``/metrics`` server
(:mod:`.worker`) renders with them; ``chip_smoke.py`` checks its scrapes
with :func:`parse_exposition`."""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple


def format_value(v: float) -> str:
    """Sample-value formatting, safe for the non-finite values a diverged
    run produces (``int(nan)`` raises; a NaN loss must not take the whole
    scrape down with it)."""
    v = float(v)
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return "%d" % v if v == int(v) else "%.6f" % v


def escape_label_value(value: str) -> str:
    """Prometheus label escaping of backslash, newline and double quote:
    an unescaped value would corrupt the whole scrape."""
    return (str(value).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def http_respond(req: Any, code: int, body: bytes,
                 ctype: str = "text/plain") -> None:
    """The one response writer for the port's stdlib HTTP handlers:
    headers + body, with the client-went-away errors swallowed."""
    req.send_response(code)
    req.send_header("Content-Type", ctype)
    req.send_header("Content-Length", str(len(body)))
    req.end_headers()
    try:
        req.wfile.write(body)
    except (BrokenPipeError, ConnectionResetError):
        pass


# ---------------------------------------------------------------------------
# Prometheus text-format validation
# ---------------------------------------------------------------------------

def fold_suffix(metric: str, get_type: Callable[[str], Optional[str]]
                ) -> Optional[str]:
    """A sample's family: the name itself if ``get_type`` knows it, else a
    ``_bucket``/``_sum``/``_count`` fold onto a histogram or summary base;
    None when no declared family matches."""
    if get_type(metric) is not None:
        return metric
    for suffix, kinds in (("_bucket", ("histogram",)),
                          ("_sum", ("histogram", "summary")),
                          ("_count", ("histogram", "summary"))):
        if metric.endswith(suffix):
            base = metric[: -len(suffix)]
            if get_type(base) in kinds:
                return base
    return None


def _valid_name(name: str) -> bool:
    if not name:
        return False
    ok_first = name[0].isalpha() or name[0] in "_:"
    return ok_first and all(c.isalnum() or c in "_:" for c in name)


def _parse_labels(raw: str) -> Tuple[Optional[Dict[str, str]], Optional[str]]:
    """Parse the inside of ``{...}``. Returns (labels, error)."""
    labels: Dict[str, str] = {}
    i, n = 0, len(raw)
    while i < n:
        j = i
        while j < n and (raw[j].isalnum() or raw[j] == "_"):
            j += 1
        name = raw[i:j]
        if not name or not (name[0].isalpha() or name[0] == "_"):
            return None, "bad label name at %r" % raw[i:i + 12]
        if j >= n or raw[j] != "=":
            return None, "expected '=' after label %r" % name
        j += 1
        if j >= n or raw[j] != '"':
            return None, "label %r value not quoted" % name
        j += 1
        value = []
        while j < n:
            c = raw[j]
            if c == "\\":
                if j + 1 >= n or raw[j + 1] not in ('\\', '"', 'n'):
                    return None, "bad escape in label %r" % name
                value.append({"\\": "\\", '"': '"', "n": "\n"}[raw[j + 1]])
                j += 2
                continue
            if c == '"':
                break
            if c == "\n":
                return None, "raw newline in label %r" % name
            value.append(c)
            j += 1
        else:
            return None, "unterminated value for label %r" % name
        labels[name] = "".join(value)
        j += 1  # closing quote
        if j < n and raw[j] == ",":
            j += 1
        elif j < n:
            return None, "expected ',' between labels at %r" % raw[j:j + 12]
        i = j
    return labels, None


def parse_exposition(text: str) -> List[str]:
    """Strictly validate Prometheus text exposition; returns a list of
    error strings (empty = valid). Checks:

    * every sample belongs to a declared (``# TYPE``-ed) family —
      ``_bucket``/``_sum``/``_count`` suffixes allowed for histogram and
      summary families;
    * each family is declared exactly once, HELP/TYPE before its samples,
      and a family's samples are contiguous (no interleaving);
    * label blocks parse strictly (escaped ``\\``/``"``/newlines only);
    * sample values parse as floats.
    """
    errors: List[str] = []
    types: Dict[str, str] = {}
    helped: set = set()
    closed: set = set()   # families whose sample run has ended
    current: Optional[str] = None

    def family_of(metric: str) -> Optional[str]:
        return fold_suffix(metric, types.get)

    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            parts = line.split(" ", 3)
            if len(parts) < 3:
                errors.append("line %d: malformed HELP" % lineno)
                continue
            fam = parts[2]
            if fam in helped:
                errors.append("line %d: duplicate HELP for %s" % (lineno, fam))
            helped.add(fam)
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ")
            if len(parts) != 4:
                errors.append("line %d: malformed TYPE" % lineno)
                continue
            fam, mtype = parts[2], parts[3]
            if fam in types:
                errors.append("line %d: duplicate TYPE for %s" % (lineno, fam))
                continue
            if mtype not in ("counter", "gauge", "histogram", "summary",
                             "untyped"):
                errors.append("line %d: unknown type %r" % (lineno, mtype))
            if not _valid_name(fam):
                errors.append("line %d: bad family name %r" % (lineno, fam))
            types[fam] = mtype
            if current is not None and current != fam:
                closed.add(current)
            current = fam
            continue
        if line.startswith("#"):
            continue  # comment
        # sample line: name[{labels}] value [timestamp]
        brace = line.find("{")
        if brace >= 0:
            metric = line[:brace]
            close = line.rfind("}")
            if close < brace:
                errors.append("line %d: unbalanced label braces" % lineno)
                continue
            labels_raw = line[brace + 1:close]
            rest = line[close + 1:].strip()
            _labels, err = _parse_labels(labels_raw)
            if err:
                errors.append("line %d: %s" % (lineno, err))
        else:
            metric, _, rest = line.partition(" ")
            rest = rest.strip()
        if not _valid_name(metric):
            errors.append("line %d: bad metric name %r" % (lineno, metric))
            continue
        fam = family_of(metric)
        if fam is None:
            errors.append("line %d: sample %r has no declared family"
                          % (lineno, metric))
            continue
        if fam != current:
            if fam in closed:
                errors.append(
                    "line %d: samples for %s are not contiguous"
                    % (lineno, fam))
            if current is not None:
                closed.add(current)
            current = fam
        try:
            float(rest.split(" ")[0])
        except (ValueError, IndexError):
            errors.append("line %d: unparseable value %r" % (lineno, rest))
    return errors
