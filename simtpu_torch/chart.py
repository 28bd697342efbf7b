"""Offline Helm chart rendering.

Mirrors `pkg/chart/chart.go:18-118` (`ProcessChart` → load, override name,
coalesce values, render templates offline, drop NOTES.txt, drop hooks, sort
manifests in Helm's InstallOrder, drop empties). The reference links the Helm
v3 engine; no helm binary exists in this image, so this module implements the
Go-template subset Helm charts actually use for manifests: field access
(`.Values.a.b`, `$.` root), `if / else if / else / end`, `range` (with
`$i, $v :=` variable forms and `else`), `with`, variables (`$x := expr`,
`$x = expr`), `define` / `include` / `template` / `block` partials
(`_helpers.tpl` registers into a chart-wide namespace), parenthesized
pipelines, comments, and a sprig-lite function set (`quote`, `default`,
`indent`/`nindent`, `toYaml`/`toJson`, `printf`, string/list/dict/arithmetic
helpers, `required`, `tpl`, `lookup`).

Unsupported constructs raise `ChartRenderError` naming the template file, so
a chart outside the subset fails loudly rather than mis-rendering.
"""

from __future__ import annotations

import os
import re
import tarfile
from typing import Any, Dict, List, Optional, Tuple

import yaml

NOTES_SUFFIX = "NOTES.txt"

# helm.sh/helm/v3/pkg/releaseutil/kind_sorter.go InstallOrder
INSTALL_ORDER = [
    "Namespace", "NetworkPolicy", "ResourceQuota", "LimitRange",
    "PodSecurityPolicy", "PodDisruptionBudget", "ServiceAccount", "Secret",
    "SecretList", "ConfigMap", "StorageClass", "PersistentVolume",
    "PersistentVolumeClaim", "CustomResourceDefinition", "ClusterRole",
    "ClusterRoleList", "ClusterRoleBinding", "ClusterRoleBindingList",
    "Role", "RoleList", "RoleBinding", "RoleBindingList", "Service",
    "DaemonSet", "Pod", "ReplicationController", "ReplicaSet", "Deployment",
    "HorizontalPodAutoscaler", "StatefulSet", "Job", "CronJob", "Ingress",
    "APIService",
]
_KIND_RANK = {k: i for i, k in enumerate(INSTALL_ORDER)}


class ChartRenderError(ValueError):
    pass


# ---------------------------------------------------------------------------
# Template engine (Go text/template subset)
# ---------------------------------------------------------------------------

_ACTION_RE = re.compile(r"\{\{(-?)\s*(.*?)\s*(-?)\}\}", re.DOTALL)


class _Node:
    pass


class _Text(_Node):
    def __init__(self, s):
        self.s = s


class _Expr(_Node):
    def __init__(self, src):
        self.src = src


class _If(_Node):
    def __init__(self):
        # [(cond_src | None for else, [children])]
        self.branches: List[Tuple[Optional[str], List[_Node]]] = []


class _Range(_Node):
    def __init__(self, idx_var, val_var, src):
        self.idx_var = idx_var  # $i name or None
        self.val_var = val_var  # $v name or None
        self.src = src
        self.body: List[_Node] = []
        self.else_body: List[_Node] = []


class _With(_Node):
    def __init__(self, src):
        self.src = src
        self.body: List[_Node] = []
        self.else_body: List[_Node] = []


class _Var(_Node):
    def __init__(self, name, src, declare):
        self.name = name  # without the $
        self.src = src
        self.declare = declare  # := vs =


class _Define(_Node):
    def __init__(self, name, render_in_place=False, arg_src=None):
        self.name = name
        self.body: List[_Node] = []
        self.render_in_place = render_in_place  # block vs define
        self.arg_src = arg_src  # block's pipeline argument (None for define)


class _TemplateCall(_Node):
    def __init__(self, name, arg_src):
        self.name = name
        self.arg_src = arg_src  # None = no-arg form (dot is nil in Go)


_VAR_STMT_RE = re.compile(r"^\$([\w]+)\s*(:?=)\s*(.*)$", re.DOTALL)
_RANGE_VARS_RE = re.compile(
    r"^range\s+\$([\w]+)\s*(?:,\s*\$([\w]+)\s*)?:=\s*(.*)$", re.DOTALL
)
_TEMPLATE_RE = re.compile(r'^(template|block)\s+("[^"]*"|`[^`]*`)\s*(.*)$', re.DOTALL)
_DEFINE_RE = re.compile(r'^define\s+("[^"]*"|`[^`]*`)\s*$')


def _parse(template: str, where: str) -> List[_Node]:
    """Split into text/action nodes, honoring {{- and -}} whitespace trim."""
    pos = 0
    tokens: List[Tuple[str, str]] = []  # ("text", s) | ("action", src)
    for m in _ACTION_RE.finditer(template):
        text = template[pos : m.start()]
        if m.group(1) == "-":
            text = text.rstrip()
        if tokens and tokens[-1][0] == "trim-next":
            tokens.pop()
            text = text.lstrip()
        tokens.append(("text", text))
        tokens.append(("action", m.group(2)))
        if m.group(3) == "-":
            tokens.append(("trim-next", ""))
        pos = m.end()
    tail = template[pos:]
    if tokens and tokens[-1][0] == "trim-next":
        tokens.pop()
        tail = tail.lstrip()
    tokens.append(("text", tail))

    root: List[_Node] = []
    # stack entries: (children_list, owner node | None); `else`/`else if`
    # re-target the list according to the owner's type
    stack: List[Tuple[List[_Node], Optional[_Node]]] = [(root, None)]
    for kind, payload in tokens:
        children = stack[-1][0]
        if kind == "text":
            if payload:
                children.append(_Text(payload))
            continue
        src = payload
        if src.startswith("/*"):
            continue
        if src.startswith("if "):
            node = _If()
            node.branches.append((src[3:].strip(), []))
            children.append(node)
            stack.append((node.branches[-1][1], node))
        elif src.startswith("else if "):
            _, node = stack.pop()
            if not isinstance(node, _If):
                raise ChartRenderError(f"{where}: 'else if' outside if")
            if node.branches and node.branches[-1][0] is None:
                raise ChartRenderError(f"{where}: 'else if' after 'else'")
            node.branches.append((src[8:].strip(), []))
            stack.append((node.branches[-1][1], node))
        elif src == "else":
            prev_list, node = stack.pop()
            if isinstance(node, _If):
                if node.branches and node.branches[-1][0] is None:
                    raise ChartRenderError(f"{where}: duplicate 'else'")
                node.branches.append((None, []))
                stack.append((node.branches[-1][1], node))
            elif isinstance(node, (_Range, _With)):
                if prev_list is node.else_body:
                    raise ChartRenderError(f"{where}: duplicate 'else'")
                stack.append((node.else_body, node))
            else:
                raise ChartRenderError(f"{where}: 'else' outside if/range/with")
        elif src == "end":
            _, node = stack.pop()
            if node is None:
                raise ChartRenderError(f"{where}: unmatched 'end'")
        elif src.startswith("range ") or src == "range":
            m2 = _RANGE_VARS_RE.match(src)
            if m2:
                idx_var, val_var, expr = m2.group(1), m2.group(2), m2.group(3)
                if val_var is None:
                    # `range $v := x` — single variable binds the VALUE
                    idx_var, val_var = None, idx_var
            else:
                idx_var = val_var = None
                expr = src[len("range") :].strip()
                if not expr:
                    raise ChartRenderError(f"{where}: range needs an argument")
            node = _Range(idx_var, val_var, expr)
            children.append(node)
            stack.append((node.body, node))
        elif src.startswith("with "):
            node = _With(src[5:].strip())
            children.append(node)
            stack.append((node.body, node))
        elif src.startswith("define ") or src.startswith("block "):
            is_block = src.startswith("block ")
            if is_block:
                m2 = _TEMPLATE_RE.match(src)
                if not m2:
                    raise ChartRenderError(f"{where}: malformed block '{src}'")
                node = _Define(
                    m2.group(2)[1:-1],
                    render_in_place=True,
                    arg_src=m2.group(3).strip() or None,
                )
            else:
                m2 = _DEFINE_RE.match(src)
                if not m2:
                    raise ChartRenderError(f"{where}: malformed define '{src}'")
                node = _Define(m2.group(1)[1:-1])
            children.append(node)
            stack.append((node.body, node))
        elif src.startswith("template ") or src.startswith("template\t"):
            m2 = _TEMPLATE_RE.match(src)
            if not m2:
                raise ChartRenderError(f"{where}: malformed template '{src}'")
            arg = m2.group(3).strip()
            children.append(_TemplateCall(m2.group(2)[1:-1], arg or None))
        else:
            m2 = _VAR_STMT_RE.match(src)
            if m2:
                children.append(
                    _Var(m2.group(1), m2.group(3).strip(), m2.group(2) == ":=")
                )
            else:
                children.append(_Expr(src))
    if len(stack) != 1:
        raise ChartRenderError(f"{where}: unclosed control structure")
    return root


def _tokenize_expr(src: str, where: str) -> List[str]:
    out, i, n = [], 0, len(src)
    while i < n:
        c = src[i]
        if c.isspace():
            i += 1
        elif c in "\"'`":
            j = i + 1
            while j < n and src[j] != c:
                j += 2 if src[j] == "\\" else 1
            out.append(src[i : j + 1])
            i = j + 1
        elif c == "|":
            out.append("|")
            i += 1
        elif c == "(" or c == ")":
            out.append(c)
            i += 1
        else:
            j = i
            while j < n and not src[j].isspace() and src[j] not in "|()":
                j += 1
            out.append(src[i:j])
            i = j
    return out


class _Scope:
    """Dot + root + lexically chained variables (Go template semantics:
    variables declared in a block are visible until its `end`)."""

    __slots__ = ("dot", "root", "vars", "parent")

    def __init__(self, dot, root, parent=None):
        self.dot = dot
        self.root = root
        self.vars: Dict[str, Any] = {}
        self.parent = parent

    def child(self, dot=None):
        return _Scope(self.dot if dot is None else dot, self.root, self)

    def get_var(self, name, where):
        s = self
        while s is not None:
            if name in s.vars:
                return s.vars[name]
            s = s.parent
        raise ChartRenderError(f"{where}: undefined variable '${name}'")

    def set_var(self, name, value, declare, where):
        if declare:
            self.vars[name] = value
            return
        s = self
        while s is not None:
            if name in s.vars:
                s.vars[name] = value
                return
            s = s.parent
        raise ChartRenderError(f"{where}: assignment to undeclared '${name}'")


class _Env:
    """Per-chart render environment: the define namespace (shared by every
    template file, like Helm's single template tree)."""

    def __init__(self, defines: Optional[Dict[str, List[_Node]]] = None):
        self.defines: Dict[str, List[_Node]] = defines if defines is not None else {}

    def include(self, name, dot, where):
        body = self.defines.get(name)
        if body is None:
            raise ChartRenderError(f"{where}: include of undefined template '{name}'")
        out: List[str] = []
        # Go text/template rebinds $ to each execution's data argument, so
        # inside an included template $ IS the passed dot, not the chart root
        scope = _Scope(dot, dot)
        _render_nodes(body, scope, self, out, where)
        return "".join(out)


def _field_path(value, path: str, where: str):
    for part in path.split("."):
        if not part:
            continue
        if isinstance(value, dict):
            value = value.get(part)
        else:
            value = getattr(value, part, None)
        if value is None:
            return None
    return value


def _to_yaml(v) -> str:
    return yaml.safe_dump(v, default_flow_style=False, sort_keys=False).rstrip("\n")


def _sprig_trunc(n, s):
    n = int(n)
    s = str(s)
    return s[:n] if n >= 0 else s[n:]


def _sprig_dict(*kv):
    if len(kv) % 2:
        raise ValueError("dict needs an even number of arguments")
    return {str(kv[i]): kv[i + 1] for i in range(0, len(kv), 2)}


def _required(msg, v=None):
    if v is None or v == "":
        raise ValueError(str(msg))
    return v


def _deep_merge(dst, *srcs):
    """sprig merge: deep merge into dst; dst's values win, nested maps
    merge recursively."""
    out = dict(dst or {})
    for src in srcs:
        for k, v in (src or {}).items():
            if k in out and isinstance(out[k], dict) and isinstance(v, dict):
                out[k] = _deep_merge(out[k], v)
            elif k not in out:
                out[k] = v
    return out


def _int_strict(x):
    """Integer operand for sprig arithmetic: non-integral or non-numeric
    operands raise rather than silently truncating (the fail-loud contract —
    Go/sprig would coerce through int64, changing the value). Ints pass
    through exactly (never via float, which rounds above 2^53); integral
    floats and numeric strings are accepted."""
    if isinstance(x, int) and not isinstance(x, bool):
        return x
    if isinstance(x, str):
        try:
            return int(x)  # exact for arbitrarily large integer strings
        except ValueError:
            pass  # "3.0" falls through to the float path
    try:
        f = float(x)
    except (TypeError, ValueError):
        raise ChartRenderError(f"non-numeric operand {x!r} to integer arithmetic")
    if f != int(f):
        raise ChartRenderError(f"non-integral operand {x!r} to integer arithmetic")
    return int(f)


_FUNCS = {
    "int": lambda a: int(float(a)) if a not in (None, "") else 0,
    "int64": lambda a: int(float(a)) if a not in (None, "") else 0,
    "float64": lambda a: float(a) if a not in (None, "") else 0.0,
    "quote": lambda a: '"%s"' % str(a if a is not None else "").replace('"', '\\"'),
    "squote": lambda a: "'%s'" % (a if a is not None else ""),
    "upper": lambda a: str(a).upper(),
    "lower": lambda a: str(a).lower(),
    "title": lambda a: str(a).title(),
    "trim": lambda a: str(a).strip(),
    "trimSuffix": lambda suf, s: str(s)[: -len(suf)] if suf and str(s).endswith(suf) else str(s),
    "trimPrefix": lambda pre, s: str(s)[len(pre):] if str(s).startswith(pre) else str(s),
    "trunc": _sprig_trunc,
    "abbrev": lambda n, s: (str(s)[: int(n) - 3] + "...") if len(str(s)) > int(n) else str(s),
    "replace": lambda old, new, s: str(s).replace(old, new),
    "contains": lambda sub, s: sub in str(s),
    "hasPrefix": lambda pre, s: str(s).startswith(pre),
    "hasSuffix": lambda suf, s: str(s).endswith(suf),
    "repeat": lambda n, s: str(s) * int(n),
    "nospace": lambda s: re.sub(r"\s", "", str(s)),
    "toYaml": _to_yaml,
    "toJson": lambda v: __import__("json").dumps(v),
    "fromYaml": lambda s: yaml.safe_load(s) or {},
    "toString": lambda a: _format(a) if not isinstance(a, str) else a,
    "default": lambda d, v=None: v if _truthy(v) else d,
    "coalesce": lambda *a: next((x for x in a if _truthy(x)), None),
    "ternary": lambda t, f, c: t if _truthy(c) else f,
    "empty": lambda a: not _truthy(a),
    "required": _required,
    "fail": lambda msg: (_ for _ in ()).throw(ValueError(str(msg))),
    "indent": lambda n, s: "\n".join(" " * int(n) + ln for ln in str(s).splitlines()),
    "nindent": lambda n, s: "\n" + "\n".join(" " * int(n) + ln for ln in str(s).splitlines()),
    "printf": lambda fmt, *a: _go_printf(fmt, *a),
    "print": lambda *a: "".join(_format(x) for x in a),
    "println": lambda *a: "".join(_format(x) for x in a) + "\n",
    "not": lambda a: not _truthy(a),
    "eq": lambda a, *b: any(a == x for x in b),
    "ne": lambda a, b: a != b,
    "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= b,
    "gt": lambda a, b: a > b,
    "ge": lambda a, b: a >= b,
    "and": lambda *a: next((x for x in a if not _truthy(x)), a[-1] if a else None),
    "or": lambda *a: next((x for x in a if _truthy(x)), a[-1] if a else None),
    "add": lambda *a: sum(_int_strict(x) for x in a),
    "add1": lambda a: _int_strict(a) + 1,
    "sub": lambda a, b: _int_strict(a) - _int_strict(b),
    "mul": lambda *a: __import__("math").prod(_int_strict(x) for x in a),
    "div": lambda a, b: _int_strict(a) // _int_strict(b),
    "mod": lambda a, b: _int_strict(a) % _int_strict(b),
    "max": lambda *a: max(_int_strict(x) for x in a),
    "min": lambda *a: min(_int_strict(x) for x in a),
    "len": lambda a: len(a) if a is not None else 0,
    "list": lambda *a: list(a),
    "dict": _sprig_dict,
    "get": lambda d, k: (d or {}).get(str(k), ""),
    "hasKey": lambda d, k: str(k) in (d or {}),
    "keys": lambda *ds: sorted(k for d in ds for k in (d or {})),
    "pluck": lambda k, *ds: [d[k] for d in ds if k in (d or {})],
    "merge": _deep_merge,
    "join": lambda sep, xs: str(sep).join(_format(x) for x in (xs or [])),
    "splitList": lambda sep, s: str(s).split(sep),
    "split": lambda sep, s: {f"_{i}": p for i, p in enumerate(str(s).split(sep))},
    "first": lambda xs: xs[0] if xs else None,
    "last": lambda xs: xs[-1] if xs else None,
    "rest": lambda xs: list(xs[1:]) if xs else [],
    "initial": lambda xs: list(xs[:-1]) if xs else [],
    "append": lambda xs, x: list(xs or []) + [x],
    "prepend": lambda xs, x: [x] + list(xs or []),
    "uniq": lambda xs: list(dict.fromkeys(xs or [])),
    "sortAlpha": lambda xs: sorted(str(x) for x in (xs or [])),
    "b64enc": lambda s: __import__("base64").b64encode(str(s).encode()).decode(),
    "b64dec": lambda s: __import__("base64").b64decode(str(s)).decode(),
    "sha256sum": lambda s: __import__("hashlib").sha256(str(s).encode()).hexdigest(),
    "kindIs": lambda kind, v: {
        "map": isinstance(v, dict),
        "slice": isinstance(v, list),
        "string": isinstance(v, str),
        "bool": isinstance(v, bool),
        "int": isinstance(v, int) and not isinstance(v, bool),
        "float64": isinstance(v, float),
        "invalid": v is None,
    }.get(str(kind), False),
    # offline render: no cluster to query (helm template does the same)
    "lookup": lambda *a: {},
}


def _go_printf(fmt, *args):
    out = []
    it = iter(args)
    i, n = 0, len(str(fmt))
    fmt = str(fmt)
    while i < n:
        c = fmt[i]
        if c == "%" and i + 1 < n:
            spec = fmt[i + 1]
            if spec == "%":
                out.append("%")
            elif spec == "q":
                out.append('"%s"' % _format(next(it, "")))
            elif spec == "d":
                # integral floats and numeric strings render as the integer;
                # a non-integral operand raises (Go would emit an
                # %!d(float64=...) error marker — fail loud instead)
                out.append(str(_int_strict(next(it, 0))))
            elif spec == "f":
                out.append("%f" % float(next(it, 0.0)))  # Go's 6-decimal default
            elif spec in "sv":
                out.append(_format(next(it, "")))
            else:
                raise ChartRenderError(f"printf: unsupported verb %{spec}")
            i += 2
            continue
        out.append(c)
        i += 1
    return "".join(out)


def _truthy(v) -> bool:
    if v is None or v is False:
        return False
    if isinstance(v, (int, float)) and v == 0:
        return False
    if isinstance(v, (str, list, dict)) and len(v) == 0:
        return False
    return True


def _eval_atom(tok: str, scope: _Scope, where: str):
    if tok == "." or tok == "$":
        return scope.dot if tok == "." else scope.root
    if tok.startswith("$."):
        return _field_path(scope.root, tok[2:], where)
    if tok.startswith("$"):
        name, _, rest = tok[1:].partition(".")
        val = scope.get_var(name, where)
        return _field_path(val, rest, where) if rest else val
    if tok.startswith("."):
        return _field_path(scope.dot, tok[1:], where)
    if tok[:1] in "\"'`":
        return tok[1:-1]
    if tok in ("true", "false"):
        return tok == "true"
    if tok == "nil":
        return None
    try:
        return int(tok)
    except ValueError:
        pass
    try:
        return float(tok)
    except ValueError:
        pass
    return tok  # bare word (function name handled by caller)


_SENTINEL = object()


def _parse_operands(tokens: List[str], pos: int, where: str):
    """Parse one pipeline stage's operands until `|`, `)` or EOF. Each
    operand is ("atom", tok) or ("pipe", stages)."""
    ops = []
    n = len(tokens)
    while pos < n and tokens[pos] not in ("|", ")"):
        if tokens[pos] == "(":
            stages, pos = _parse_stages(tokens, pos + 1, where)
            if pos >= n or tokens[pos] != ")":
                raise ChartRenderError(f"{where}: unclosed '('")
            pos += 1
            ops.append(("pipe", stages))
        else:
            ops.append(("atom", tokens[pos]))
            pos += 1
    return ops, pos


def _parse_stages(tokens: List[str], pos: int, where: str):
    """Parse a pipeline (stages separated by `|`) until `)` or EOF."""
    stages = []
    while True:
        ops, pos = _parse_operands(tokens, pos, where)
        stages.append(ops)
        if pos < len(tokens) and tokens[pos] == "|":
            pos += 1
            continue
        return stages, pos


def _eval_operand(op, scope: _Scope, env: _Env, where: str):
    kind, payload = op
    if kind == "pipe":
        return _eval_stages(payload, scope, env, where)
    return _eval_atom(payload, scope, where)


def _eval_stage(ops, piped, scope: _Scope, env: _Env, where: str):
    """One pipeline stage: `fn a b` or a single operand; `piped` is appended
    as the last argument (Go pipeline semantics)."""
    if not ops:
        raise ChartRenderError(f"{where}: empty pipeline stage")
    head_kind, head = ops[0]
    if head_kind == "atom" and (head in _FUNCS or head in ("include", "tpl", "template")):
        args = [_eval_operand(op, scope, env, where) for op in ops[1:]]
        if piped is not _SENTINEL:
            args.append(piped)
        try:
            if head == "include":
                return env.include(
                    str(args[0]), args[1] if len(args) > 1 else None, where
                )
            if head == "tpl":
                # render a string as a template against the given context
                tpl_src, dot = str(args[0]), args[1] if len(args) > 1 else None
                out: List[str] = []
                _render_nodes(_parse(tpl_src, where), _Scope(dot, dot), env, out, where)
                return "".join(out)
            if head == "template":
                raise ChartRenderError(
                    f"{where}: 'template' is a statement; use 'include' in pipelines"
                )
            return _FUNCS[head](*args)
        except ChartRenderError:
            raise
        except Exception as exc:
            raise ChartRenderError(f"{where}: {head}(...) failed: {exc}") from exc
    if len(ops) != 1 or piped is not _SENTINEL:
        raise ChartRenderError(f"{where}: unknown function '{head}'")
    return _eval_operand(ops[0], scope, env, where)


def _eval_stages(stages, scope: _Scope, env: _Env, where: str):
    val = _SENTINEL
    for stage in stages:
        val = _eval_stage(stage, val, scope, env, where)
    return val


def _eval_expr(src: str, scope: _Scope, env: _Env, where: str):
    tokens = _tokenize_expr(src, where)
    stages, pos = _parse_stages(tokens, 0, where)
    if pos != len(tokens):
        raise ChartRenderError(f"{where}: unexpected '{tokens[pos]}' in '{src}'")
    return _eval_stages(stages, scope, env, where)


def _format(v) -> str:
    if v is None:
        return "<no value>"
    if v is True:
        return "true"
    if v is False:
        return "false"
    if isinstance(v, float) and v == int(v):
        return str(int(v))
    return str(v)


def _range_items(val, where: str):
    """(key-or-index, value) pairs; maps iterate in sorted key order like Go
    text/template."""
    if val is None:
        return []
    if isinstance(val, dict):
        return [(k, val[k]) for k in sorted(val, key=str)]
    if isinstance(val, (list, tuple)):
        return list(enumerate(val))
    if isinstance(val, str):
        return list(enumerate(val))
    if isinstance(val, int):
        return list(enumerate(range(val)))  # Go 1.22 range-over-int
    raise ChartRenderError(f"{where}: cannot range over {type(val).__name__}")


def _render_nodes(nodes: List[_Node], scope: _Scope, env: _Env, out: List[str], where: str):
    for node in nodes:
        if isinstance(node, _Text):
            out.append(node.s)
        elif isinstance(node, _Expr):
            out.append(_format(_eval_expr(node.src, scope, env, where)))
        elif isinstance(node, _Var):
            scope.set_var(
                node.name, _eval_expr(node.src, scope, env, where), node.declare, where
            )
        elif isinstance(node, _If):
            for cond, children in node.branches:
                if cond is None or _truthy(_eval_expr(cond, scope, env, where)):
                    _render_nodes(children, scope.child(), env, out, where)
                    break
        elif isinstance(node, _Range):
            items = _range_items(_eval_expr(node.src, scope, env, where), where)
            if not items:
                _render_nodes(node.else_body, scope.child(), env, out, where)
                continue
            for k, v in items:
                body_scope = scope.child(dot=v)
                if node.idx_var:
                    body_scope.vars[node.idx_var] = k
                if node.val_var:
                    body_scope.vars[node.val_var] = v
                _render_nodes(node.body, body_scope, env, out, where)
        elif isinstance(node, _With):
            val = _eval_expr(node.src, scope, env, where)
            if _truthy(val):
                _render_nodes(node.body, scope.child(dot=val), env, out, where)
            else:
                _render_nodes(node.else_body, scope.child(), env, out, where)
        elif isinstance(node, _Define):
            env.defines.setdefault(node.name, node.body)
            if node.render_in_place:  # block = define + immediate render
                dot = (
                    _eval_expr(node.arg_src, scope, env, where)
                    if node.arg_src is not None
                    else scope.dot
                )
                out.append(env.include(node.name, dot, where))
        elif isinstance(node, _TemplateCall):
            dot = (
                _eval_expr(node.arg_src, scope, env, where)
                if node.arg_src is not None
                else None
            )
            out.append(env.include(node.name, dot, where))


def collect_defines(template: str, where: str, env: _Env) -> List[_Node]:
    """Parse a template file and register every `define` into the chart-wide
    namespace (Helm parses all files into one template tree, so partials in
    `_helpers.tpl` are visible everywhere). Returns the parse for reuse."""
    nodes = _parse(template, where)

    def walk(ns):
        for nd in ns:
            if isinstance(nd, _Define):
                env.defines.setdefault(nd.name, nd.body)
                walk(nd.body)
            elif isinstance(nd, _If):
                for _, children in nd.branches:
                    walk(children)
            elif isinstance(nd, (_Range, _With)):
                walk(nd.body)
                walk(nd.else_body)

    walk(nodes)
    return nodes


def render_template(
    template: str, ctx: dict, where: str = "<template>", env: Optional[_Env] = None
) -> str:
    out: List[str] = []
    _render_nodes(
        _parse(template, where), _Scope(ctx, ctx), env or _Env(), out, where
    )
    return "".join(out)


# ---------------------------------------------------------------------------
# Chart loading (directory or .tgz, like helm loader.Load)
# ---------------------------------------------------------------------------


def _load_chart_files(chart_path: str) -> Dict[str, str]:
    """Relative path → content for Chart.yaml, values.yaml, templates/*."""
    files: Dict[str, str] = {}
    if os.path.isdir(chart_path):
        for root, _dirs, names in os.walk(chart_path):
            for name in names:
                full = os.path.join(root, name)
                rel = os.path.relpath(full, chart_path)
                with open(full, "r", encoding="utf-8") as fh:
                    files[rel] = fh.read()
    elif tarfile.is_tarfile(chart_path):
        with tarfile.open(chart_path) as tf:
            for member in tf.getmembers():
                if not member.isfile():
                    continue
                rel = member.name.split("/", 1)[-1]  # strip top-level dir
                data = tf.extractfile(member).read().decode("utf-8")
                files[rel] = data
    else:
        raise ChartRenderError(f"{chart_path}: not a chart directory or archive")
    if "Chart.yaml" not in files:
        raise ChartRenderError(f"{chart_path}: no Chart.yaml")
    return files


def process_chart(name: str, chart_path: str) -> List[str]:
    """Render a chart into YAML manifest strings in InstallOrder.

    `name` overrides the chart name (`chart.go:24`
    `chartRequested.Metadata.Name = name`), which also becomes
    `.Release.Name` (`chart.go:59` uses `chrt.Name()`).
    """
    files = _load_chart_files(chart_path)
    metadata = yaml.safe_load(files["Chart.yaml"]) or {}
    chart_type = metadata.get("type") or ""
    if chart_type not in ("", "application"):
        # checkIfInstallable (chart.go:45-51)
        raise ChartRenderError(f"{chart_type} charts are not installable")
    metadata["name"] = name
    values = yaml.safe_load(files.get("values.yaml", "")) or {}
    ctx = {
        "Values": values,
        "Chart": {**metadata, "Name": name},
        "Release": {
            "Name": name,
            "Namespace": "default",
            "Revision": 1,
            "Service": "Helm",
        },
        "Capabilities": {"KubeVersion": {"Version": "v1.20.5", "Major": "1", "Minor": "20"}},
    }

    # pass 1: parse every template file and register defines into one
    # chart-wide namespace (Helm's single template tree — `_helpers.tpl`
    # partials are visible from every manifest)
    env = _Env()
    parsed: Dict[str, List[_Node]] = {}
    for rel in sorted(files):
        parts = rel.split(os.sep)
        if parts[0] != "templates" or len(parts) < 2:
            continue
        if rel.endswith(NOTES_SUFFIX):
            continue
        parsed[rel] = collect_defines(files[rel], rel, env)

    docs: List[Tuple[int, int, str]] = []  # (kind_rank, seq, content)
    seq = 0
    for rel in sorted(parsed):
        base = rel.split(os.sep)[-1]
        if base.startswith("_"):
            continue  # partials render nothing themselves (chart.go:92-103)
        out: List[str] = []
        _render_nodes(parsed[rel], _Scope(ctx, ctx), env, out, rel)
        rendered = "".join(out)
        for doc in re.split(r"(?m)^---\s*$", rendered):
            if not doc.strip():
                continue  # empty manifests removed (chart.go:105-107)
            try:
                obj = yaml.safe_load(doc)
            except yaml.YAMLError as exc:
                raise ChartRenderError(f"{rel}: rendered invalid YAML: {exc}") from exc
            if not isinstance(obj, dict):
                continue
            annotations = (obj.get("metadata") or {}).get("annotations") or {}
            if "helm.sh/hook" in annotations:
                # the reference discards hooks (chart.go:110 drops the first
                # return of SortManifests)
                continue
            rank = _KIND_RANK.get(obj.get("kind"), len(INSTALL_ORDER))
            docs.append((rank, seq, doc.strip("\n")))
            seq += 1
    docs.sort(key=lambda t: (t[0], t[1]))
    return [content for _rank, _seq, content in docs]
