"""Kubernetes resource-quantity parsing.

The reference manipulates `resource.Quantity` objects throughout (e.g.
`pkg/algo/greed.go:20-31`, `pkg/simulator/plugin/simon.go:46-66`). We only ever
need quantities as scalars feeding dense arrays, so this module lowers the k8s
quantity grammar straight to floats (canonical unit: CPU in *cores*, everything
else in base units — bytes for memory/storage).

Grammar (mirrors apimachinery's resource.Quantity):
    <number><suffix>
    suffix ∈ {"", m, k, M, G, T, P, E, Ki, Mi, Gi, Ti, Pi, Ei, n, u}
"""

from __future__ import annotations

_SUFFIX = {
    "": 1.0,
    "n": 1e-9,
    "u": 1e-6,
    "m": 1e-3,
    "k": 1e3,
    "M": 1e6,
    "G": 1e9,
    "T": 1e12,
    "P": 1e15,
    "E": 1e18,
    "Ki": 2.0**10,
    "Mi": 2.0**20,
    "Gi": 2.0**30,
    "Ti": 2.0**40,
    "Pi": 2.0**50,
    "Ei": 2.0**60,
}


# quantity strings repeat massively across pods/nodes (every replica shares
# its template's "100m"/"64Gi"); memoize with a bounded cache
_CACHE: dict = {}
_CACHE_MAX = 1 << 16


def parse_quantity(value) -> float:
    """Parse a k8s quantity ("1500m", "16Gi", 2, "32560Mi") to a float scalar."""
    if value is None:
        return 0.0
    if isinstance(value, (int, float)):
        return float(value)
    s = str(value).strip()
    if not s:
        return 0.0
    hit = _CACHE.get(s)
    if hit is not None:
        return hit
    # exponent form like "1e3" is legal in the k8s grammar
    i = len(s)
    while i > 0 and not (s[i - 1].isdigit() or s[i - 1] == "."):
        i -= 1
    num, suffix = s[:i], s[i:]
    if suffix not in _SUFFIX:
        # maybe scientific notation ("12e6"): float() handles it, no suffix
        try:
            out = float(s)
        except ValueError as exc:
            raise ValueError(f"unparseable quantity {value!r}") from exc
    elif not num:
        raise ValueError(f"unparseable quantity {value!r}")
    else:
        out = float(num) * _SUFFIX[suffix]
    if len(_CACHE) >= _CACHE_MAX:
        _CACHE.clear()
    _CACHE[s] = out
    return out


def format_quantity(value: float, unit: str = "") -> str:
    """Render a float back into a human-readable quantity for reports.

    unit="cpu" renders millicores below 10 cores; unit="mem" renders Gi/Mi.
    """
    if unit == "cpu":
        if value == int(value) and value >= 10:
            return str(int(value))
        m = value * 1000
        if m == int(m):
            return f"{int(m)}m"
        return f"{m:.1f}m"
    if unit == "mem":
        for suf, mult in (("Ti", 2.0**40), ("Gi", 2.0**30), ("Mi", 2.0**20), ("Ki", 2.0**10)):
            if value >= mult:
                v = value / mult
                if v == int(v):
                    return f"{int(v)}{suf}"
                return f"{v:.2f}{suf}"
        return str(int(value))
    if value == int(value):
        return str(int(value))
    return f"{value:.3f}"
