"""Math-expression evaluator for ``filterdb --filter-expression``.

A from-scratch recursive-descent parser matching the grammar and operator
set of the reference's vendored tinyexpr (lib/tinyexpr/tinyexpr.c:440-620,
with the MMseqs2 logical/comparison extensions at :228-239 and the
``$1``..``$128`` column variables of ExpressionParser.cpp:8-27):

    list   = expr {"," expr}          (comma returns the right side)
    expr   = test {("&&" | "||") test}
    test   = sum  {(">" | ">=" | "<" | "<=" | "==" | "!=") sum}
    sum    = term {("+" | "-") term}
    term   = factor {("*" | "/" | "%") factor}
    factor = power {"^" power}        (left-assoc: TE_POW_FROM_RIGHT is off)
    power  = {("-" | "+" | "!")} base
    base   = number | "$" digits | func ["(" args ")"] | "(" list ")"

``log`` is base-10 (TE_NAT_LOG off), ``ln`` is natural. Variables bind
0-based column values like ExpressionParser::bind (``$1`` = column 0);
unbound/unparseable columns keep their previous value (the reference keeps
the stale ``variables[]`` slot). Evaluation: a result of 0 means "drop the
line" (filterdb.cpp:326-341).
"""
import math

_CONSTS = {"e": math.e, "pi": math.pi}


def _fac(a):
    if a < 0.0 or a != a:
        return float("nan")
    if a > 170.0:
        return float("inf")
    return float(math.factorial(int(a)))


def _ncr(n, r):
    if n < 0.0 or r < 0.0 or n < r or n != n or r != r:
        return float("nan")
    un, ur = int(n), int(r)
    ur = min(ur, un - ur)
    out = 1.0
    for i in range(1, ur + 1):
        if out * (un - ur + i) == float("inf"):
            return float("inf")
        out *= un - ur + i
        out /= i
    return out


def _div(a, b):
    try:
        return a / b
    except ZeroDivisionError:
        return math.copysign(float("inf"), a) if a else float("nan")


def _fmod(a, b):
    try:
        return math.fmod(a, b)
    except ValueError:
        return float("nan")


def _pow(a, b):
    """C99 pow semantics: NaN for negative base with fractional exponent,
    +-inf on overflow/0^negative (Python's ** returns complex or raises)."""
    try:
        return math.pow(a, b)
    except ValueError:
        return float("nan")
    except OverflowError:
        return float("inf")
    except ZeroDivisionError:
        return math.copysign(float("inf"), a) if b % 2 == 1 else float("inf")


def _wrap1(f):
    def g(a):
        try:
            return f(a)
        except (ValueError, OverflowError):
            return float("nan")
    return g


_FUNCS1 = {
    "abs": abs, "acos": _wrap1(math.acos), "asin": _wrap1(math.asin),
    "atan": math.atan, "ceil": math.ceil, "cos": math.cos,
    "cosh": _wrap1(math.cosh), "exp": _wrap1(math.exp), "fac": _fac,
    "floor": math.floor, "ln": _wrap1(math.log), "log": _wrap1(math.log10),
    "log10": _wrap1(math.log10), "sin": math.sin, "sinh": _wrap1(math.sinh),
    "sqrt": _wrap1(math.sqrt), "tan": math.tan, "tanh": math.tanh,
}
_FUNCS2 = {
    "atan2": math.atan2, "fmod": _fmod, "ncr": _ncr,
    "npr": lambda n, r: _ncr(n, r) * _fac(r), "pow": _pow,
}


class ExprError(ValueError):
    pass


class _Parser:
    def __init__(self, text):
        self.text = text
        self.pos = 0
        self.vars_used = set()

    def _skip(self):
        while self.pos < len(self.text) and self.text[self.pos] in " \t\n\r":
            self.pos += 1

    def _peek(self, n=1):
        return self.text[self.pos:self.pos + n]

    def _match(self, tok):
        self._skip()
        if self.text.startswith(tok, self.pos):
            # don't take "<" when the input is "<=", "&"-alone is an error
            if tok in ("<", ">") and self._peek(2) == tok + "=":
                return False
            self.pos += len(tok)
            return True
        return False

    # grammar levels, each returns a closure over the variables dict
    def parse(self):
        node = self._list()
        self._skip()
        if self.pos != len(self.text):
            raise ExprError(f"trailing input at {self.pos}: "
                            f"{self.text[self.pos:]!r}")
        return node

    def _list(self):
        node = self._expr()
        while self._match(","):
            rhs = self._expr()
            node = (lambda a, b: lambda v: (a(v), b(v))[1])(node, rhs)
        return node

    def _expr(self):
        node = self._test()
        while True:
            if self._match("&&"):
                rhs = self._test()
                node = (lambda a, b: lambda v: float(
                    a(v) != 0.0 and b(v) != 0.0))(node, rhs)
            elif self._match("||"):
                rhs = self._test()
                node = (lambda a, b: lambda v: float(
                    a(v) != 0.0 or b(v) != 0.0))(node, rhs)
            else:
                return node

    _TESTS = (
        (">=", lambda x, y: float(x >= y)), ("<=", lambda x, y: float(x <= y)),
        ("==", lambda x, y: float(x == y)), ("!=", lambda x, y: float(x != y)),
        (">", lambda x, y: float(x > y)), ("<", lambda x, y: float(x < y)),
    )

    def _test(self):
        node = self._sum()
        while True:
            for tok, fn in self._TESTS:
                if self._match(tok):
                    rhs = self._sum()
                    node = (lambda a, b, f: lambda v: f(a(v), b(v)))(
                        node, rhs, fn)
                    break
            else:
                return node

    def _sum(self):
        node = self._term()
        while True:
            if self._match("+"):
                rhs = self._term()
                node = (lambda a, b: lambda v: a(v) + b(v))(node, rhs)
            elif self._match("-"):
                rhs = self._term()
                node = (lambda a, b: lambda v: a(v) - b(v))(node, rhs)
            else:
                return node

    def _term(self):
        node = self._factor()
        while True:
            if self._match("*"):
                rhs = self._factor()
                node = (lambda a, b: lambda v: a(v) * b(v))(node, rhs)
            elif self._match("/"):
                rhs = self._factor()
                node = (lambda a, b: lambda v: _div(a(v), b(v)))(node, rhs)
            elif self._match("%"):
                rhs = self._factor()
                node = (lambda a, b: lambda v: _fmod(a(v), b(v)))(node, rhs)
            else:
                return node

    def _factor(self):
        node = self._power()
        while self._match("^"):
            rhs = self._power()
            node = (lambda a, b: lambda v: _pow(a(v), b(v)))(node, rhs)
        return node

    def _power(self):
        # {("-"|"+")} then {("-"|"+"|"!")} exactly as tinyexpr.c:454-472:
        # '!' after the sign block folds into logical not / notnot
        sign = 1
        while True:
            self._skip()
            c = self._peek()
            if c == "+" or c == "-":
                if c == "-":
                    sign = -sign
                self.pos += 1
            else:
                break
        logical = 0
        while True:
            self._skip()
            c = self._peek()
            if c == "!" and self._peek(2) != "!=":
                logical = -1 if logical == 0 else -logical
                self.pos += 1
            elif c and c in "+-":  # c == "" at EOF ("" in "+-" is True!)
                if c == "-":
                    # the second loop still folds signs (tinyexpr keeps
                    # accepting +/- but ignores them for the sign; it only
                    # tracked sign in the first loop) — match that: ignore
                    pass
                self.pos += 1
            else:
                break
        base = self._base()
        if sign == 1:
            if logical == 0:
                return base
            if logical == -1:
                return lambda v, b=base: float(b(v) == 0.0)
            return lambda v, b=base: float(b(v) != 0.0)
        if logical == 0:
            return lambda v, b=base: -b(v)
        if logical == -1:
            return lambda v, b=base: -float(b(v) == 0.0)
        return lambda v, b=base: -float(b(v) != 0.0)

    def _base(self):
        self._skip()
        if self.pos >= len(self.text):
            raise ExprError("unexpected end of expression")
        c = self.text[self.pos]
        if c == "(":
            self.pos += 1
            node = self._list()
            if not self._match(")"):
                raise ExprError("missing )")
            return node
        if c == "$":
            self.pos += 1
            start = self.pos
            while self.pos < len(self.text) and self.text[self.pos].isdigit():
                self.pos += 1
            if start == self.pos:
                raise ExprError("$ without column number")
            n = int(self.text[start:self.pos])
            if not 1 <= n <= 128:
                raise ExprError(f"column ${n} out of range")
            idx = n - 1
            self.vars_used.add(idx)
            return lambda v, i=idx: v[i]
        if c.isdigit() or c == ".":
            start = self.pos
            while (self.pos < len(self.text)
                   and (self.text[self.pos].isdigit()
                        or self.text[self.pos] in ".eE"
                        or (self.text[self.pos] in "+-"
                            and self.text[self.pos - 1] in "eE"))):
                self.pos += 1
            try:
                return (lambda x: lambda v: x)(float(self.text[start:self.pos]))
            except ValueError:
                raise ExprError(
                    f"bad number {self.text[start:self.pos]!r}")
        if c.isalpha() or c == "_":
            start = self.pos
            while (self.pos < len(self.text)
                   and (self.text[self.pos].isalnum()
                        or self.text[self.pos] == "_")):
                self.pos += 1
            name = self.text[start:self.pos]
            if name in _CONSTS:
                return (lambda x: lambda v: x)(_CONSTS[name])
            if name in _FUNCS1:
                # tinyexpr grammar: <function-1> <power> (tinyexpr.c:360,
                # 393-400) — the argument needs no parentheses ('sqrt $1',
                # 'log 100'), and 'sqrt 2+1' means sqrt(2)+1; parenthesized
                # calls parse unchanged via the paren base rule
                arg = self._power()
                return (lambda f, a: lambda v: float(f(a(v))))(
                    _FUNCS1[name], arg)
            if name in _FUNCS2:
                if not self._match("("):
                    raise ExprError(f"{name} needs arguments")
                a1 = self._expr()
                if not self._match(","):
                    raise ExprError(f"{name} needs two arguments")
                a2 = self._expr()
                if not self._match(")"):
                    raise ExprError("missing )")
                return (lambda f, a, b: lambda v: float(f(a(v), b(v))))(
                    _FUNCS2[name], a1, a2)
            raise ExprError(f"unknown identifier {name!r}")
        raise ExprError(f"unexpected character {c!r} at {self.pos}")


class Expression:
    """Compiled filter expression: ``bindable`` lists the referenced
    0-based column indices; ``variables`` persists across evaluate() calls
    like ExpressionParser's member array (stale values survive parse
    failures, filterdb.cpp:329-336)."""

    def __init__(self, text):
        p = _Parser(text)
        self._fn = p.parse()
        self.bindable = sorted(p.vars_used)
        self.variables = [0.0] * 128

    def bind(self, index, value):
        if 0 <= index <= 127:
            self.variables[index] = value

    def evaluate(self):
        return self._fn(self.variables)
