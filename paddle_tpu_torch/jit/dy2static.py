"""dy2static: AST conversion of data-dependent Python control flow
(counterpart of ``paddle_tpu/jit/dy2static.py``).

Reference analogs: the dygraph_to_static transformer pipeline
(python/paddle/fluid/dygraph/dygraph_to_static/ifelse_transformer.py,
loop_transformer.py, program_translator.py).

``torch.export`` (which ``jit.to_static`` and ``jit.save`` capture with)
runs a function's Python on fake tensors and records what it does; it
converts everything EXCEPT a Python ``if``/``while`` whose predicate is a
traced tensor, which it cannot decide (a data-dependent guard). So this
module rewrites exactly those two statement forms, bottom-up, into calls
of :func:`convert_ifelse` / :func:`convert_while`: under a trace they
emit ``torch.cond`` / ``torch._higher_order_ops.while_loop`` (the
counterparts of ``lax.cond`` / ``lax.while_loop``, with the same rule:
both branches, or every trip, give the same shapes and dtypes), and on
concrete values they run the Python branch or loop as written.

Rewrite shape (names are illustrative)::

    if x.mean() > 0:            def __pd_d2s_true_0(y):
        y = x + 1                   y = x + 1        # x read via closure
    else:                           return (y,)
        y = x - 1       ==>     def __pd_d2s_false_0(y):
                                    y = x - 1
                                    return (y,)
                                (y,) = _jst.convert_ifelse(
                                    x.mean() > 0, __pd_d2s_true_0,
                                    __pd_d2s_false_0, (y,))

Variables assigned in either branch travel as explicit arguments and
results; everything merely *read* rides the closure. A ``try/except
NameError`` guard seeds names that may be unbound before the statement
with ``UNDEFINED``, so the "defined in both branches, not before"
pattern works.

Shapes that neither ``torch.cond`` nor ``lax.cond`` can take (an early
return in one branch only, break/continue in a converted while) are left
as written: with a Python-bool predicate they run exactly as written;
with a traced predicate the trace fails and :func:`explain_trace_error`
turns the failure into a ``Dy2StaticError`` naming the function and the
line. The port accepts and refuses the programs the JAX package does.
"""
from __future__ import annotations

import ast
import functools
import inspect
import textwrap
import traceback
import types
from typing import Optional

import torch

__all__ = ["convert_to_static", "Dy2StaticError", "UNDEFINED",
           "convert_ifelse", "convert_while", "explain_trace_error"]

_PREFIX = "__pd_d2s_"
_JST = _PREFIX + "jst__"


class Dy2StaticError(Exception):
    """A control-flow construct could not be converted to static form."""


class _Undefined:
    _instance: Optional["_Undefined"] = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "<dy2static UNDEFINED>"

    def __bool__(self):
        raise Dy2StaticError(
            "read of a variable that is not assigned on the taken branch "
            "of a converted if/while")


UNDEFINED = _Undefined()


def _is_tracer(x):
    """A tensor of a ``torch.export`` trace, whose value Python cannot
    read: a fake tensor, or any tensor while the trace runs through
    TorchDynamo (which traces a ``while_loop``'s body)."""
    if not isinstance(x, torch.Tensor):
        return False
    if torch.compiler.is_compiling():
        return True
    from torch._subclasses.fake_tensor import is_fake
    return is_fake(x)


def _tree_has_tracer(tree):
    from torch.utils import _pytree as pytree
    return any(_is_tracer(leaf) for leaf in pytree.tree_leaves(tree))


# ---------------------------------------------------------------------------
# runtime helpers (targets of the generated code)
# ---------------------------------------------------------------------------

def _tensor_slots(args):
    """Positions of ``args`` that hold tensors: what ``torch.cond`` and
    ``while_loop`` carry. The rest (``UNDEFINED``, Python values) ride
    into the branch functions unchanged."""
    return [i for i, a in enumerate(args) if isinstance(a, torch.Tensor)]


def _with(args, slots, values):
    full = list(args)
    for i, v in zip(slots, values):
        full[i] = v
    return full


def convert_ifelse(pred, true_fn, false_fn, args):
    """Branch on ``pred``: the Python branch for a concrete value,
    ``torch.cond`` for a traced one."""
    if _is_tracer(pred):
        slots = _tensor_slots(args)

        def branch(fn):
            def run(*carried):
                return tuple(fn(*_with(args, slots, carried)))
            return run

        try:
            return tuple(torch.cond(pred, branch(true_fn), branch(false_fn),
                                    tuple(args[i] for i in slots)))
        except Dy2StaticError:
            raise
        except Exception as e:  # torch's own errors: one type per version
            raise Dy2StaticError(
                "both branches of a converted `if` must produce matching "
                "shapes/dtypes for every variable assigned in either "
                f"branch (a variable assigned in only one branch cannot "
                f"be traced): {e}") from e
    try:
        out = true_fn(*args) if bool(pred) else false_fn(*args)
    except (NameError, UnboundLocalError) as e:
        raise Dy2StaticError(
            f"variable read in an if-branch before assignment: {e}") from e
    return tuple(out)


def convert_while(cond_fn, body_fn, init):
    """Loop: a Python while for concrete predicates, ``while_loop`` for
    traced ones (carried variables must keep shape and dtype)."""
    pred = cond_fn(*init)
    if _is_tracer(pred) or _tree_has_tracer(list(init)):
        bad = [i for i, v in enumerate(init)
               if not isinstance(v, torch.Tensor)]
        if bad:
            raise Dy2StaticError(
                "a variable carried through a converted `while` must be "
                "a tensor initialised before the loop (loop var(s) at "
                f"position(s) {bad} are not)")
        from torch._higher_order_ops import while_loop
        try:
            return tuple(while_loop(lambda *vs: cond_fn(*vs),
                                    lambda *vs: tuple(body_fn(*vs)),
                                    tuple(init)))
        except Dy2StaticError:
            raise
        except Exception as e:  # torch's own errors: one type per version
            raise Dy2StaticError(
                "a converted `while` must keep the shape and dtype of every "
                f"variable it carries: {e}") from e

    vars_ = tuple(init)
    while bool(cond_fn(*vars_)):
        vars_ = tuple(body_fn(*vars_))
    return vars_


def explain_trace_error(exc, fn):
    """Turn the error of a trace that met a Python ``if``/``while`` on a
    traced tensor (a data-dependent guard) into a ``Dy2StaticError`` that
    names the function and the line of ``fn``'s source where it
    happened."""
    name = getattr(fn, "__qualname__", getattr(fn, "__name__", "?"))
    code = getattr(inspect.unwrap(fn), "__code__", None)
    where = ""
    if code is not None:
        frames = [f for f in traceback.extract_tb(exc.__traceback__)
                  if f.filename == code.co_filename]
        if frames:
            where = f" at {frames[-1].filename}:{frames[-1].lineno} " \
                    f"({(frames[-1].line or '').strip()!r})"
    return Dy2StaticError(
        f"to_static could not convert {name}{where}: a Python "
        "`if`/`while`/loop depends on a traced tensor value in a form "
        "dy2static does not rewrite (early return from one branch only, "
        "or break/continue inside the loop). Restructure so both branches "
        "return, or use torch.cond / while_loop directly. "
        f"Original error: {type(exc).__name__}: {exc}")


# ---------------------------------------------------------------------------
# AST analysis
# ---------------------------------------------------------------------------

class _AssignedNames(ast.NodeVisitor):
    """Names bound by a statement list, NOT descending into nested
    function/class scopes or comprehension targets."""

    def __init__(self):
        self.names = set()

    def visit_FunctionDef(self, node):
        self.names.add(node.name)

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_ClassDef = visit_FunctionDef

    def visit_Lambda(self, node):
        pass

    def visit_comprehension(self, node):
        self.visit(node.iter)
        for i in node.ifs:
            self.visit(i)

    def visit_Name(self, node):
        if isinstance(node.ctx, (ast.Store, ast.Del)):
            self.names.add(node.id)

    def visit_Import(self, node):
        for a in node.names:
            self.names.add((a.asname or a.name).split(".")[0])

    visit_ImportFrom = visit_Import


def _assigned(stmts):
    v = _AssignedNames()
    for s in stmts:
        v.visit(s)
    return {n for n in v.names if not n.startswith(_PREFIX)}


def _reads(expr):
    return {n.id for n in ast.walk(expr)
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}


class _EscapeFinder(ast.NodeVisitor):
    """Return/Break/Continue at this statement level (skipping nested
    scopes and nested loops' own break/continue)."""

    def __init__(self, skip_loop_ctl=False):
        self.returns = []
        self.breaks = []
        self._loop_depth = 1 if skip_loop_ctl else 0

    def visit_FunctionDef(self, node):
        pass

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_ClassDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    def visit_Return(self, node):
        self.returns.append(node)

    def _loop(self, node):
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    def visit_While(self, node):
        self._loop(node)

    visit_For = visit_While

    def visit_Break(self, node):
        if self._loop_depth == 0:
            self.breaks.append(node)

    visit_Continue = visit_Break


def _escapes(stmts, skip_loop_ctl=False):
    f = _EscapeFinder(skip_loop_ctl)
    # for while-bodies the body IS the loop: break/continue bind to it
    for s in stmts:
        f.visit(s)
    return f


# ---------------------------------------------------------------------------
# the transformer
# ---------------------------------------------------------------------------

def _name(id_, ctx):
    return ast.Name(id=id_, ctx=ctx)


def _tuple(names, ctx):
    return ast.Tuple(elts=[_name(n, ctx) for n in names], ctx=ctx)


def _jst_attr(fn_name):
    return ast.Attribute(value=_name(_JST, ast.Load()), attr=fn_name,
                         ctx=ast.Load())


def _guard_stmt(varname):
    """try: v\nexcept (NameError, UnboundLocalError): v = UNDEFINED"""
    return ast.Try(
        body=[ast.Expr(value=_name(varname, ast.Load()))],
        handlers=[ast.ExceptHandler(
            type=ast.Tuple(
                elts=[_name("NameError", ast.Load()),
                      _name("UnboundLocalError", ast.Load())],
                ctx=ast.Load()),
            name=None,
            body=[ast.Assign(
                targets=[_name(varname, ast.Store())],
                value=_jst_attr("UNDEFINED"))])],
        orelse=[], finalbody=[])


def _def(fn_name, params, body):
    return ast.FunctionDef(
        name=fn_name,
        args=ast.arguments(
            posonlyargs=[], args=[ast.arg(arg=p) for p in params],
            vararg=None, kwonlyargs=[], kw_defaults=[], kwarg=None,
            defaults=[]),
        body=body, decorator_list=[], returns=None)


class _ControlFlowTransformer(ast.NodeTransformer):
    def __init__(self):
        self._counter = 0

    def _next(self):
        i = self._counter
        self._counter += 1
        return i

    # --- if ---------------------------------------------------------------
    def visit_If(self, node):
        self.generic_visit(node)
        body_esc = _escapes(node.body)
        else_esc = _escapes(node.orelse)
        if body_esc.breaks or else_esc.breaks:
            # break/continue bound to an enclosing loop can't move into a
            # nested function; leave as written (loop stays Python-eager)
            return node
        if body_esc.returns or else_esc.returns:
            return self._rewrite_if_returns(node, body_esc, else_esc)
        return self._rewrite_if_assigns(node)

    def _rewrite_if_assigns(self, node):
        names = sorted(_assigned(node.body) | _assigned(node.orelse))
        i = self._next()
        tname, fname = f"{_PREFIX}true_{i}", f"{_PREFIX}false_{i}"
        ret = ast.Return(value=_tuple(names, ast.Load()))
        tdef = _def(tname, names, list(node.body) + [ret])
        fdef = _def(fname, names,
                    list(node.orelse) + [ast.Return(
                        value=_tuple(names, ast.Load()))])
        call = ast.Call(
            func=_jst_attr("convert_ifelse"),
            args=[node.test, _name(tname, ast.Load()),
                  _name(fname, ast.Load()), _tuple(names, ast.Load())],
            keywords=[])
        if names:
            final = ast.Assign(targets=[_tuple(names, ast.Store())],
                               value=call)
        else:
            final = ast.Expr(value=call)
        # original branch statements keep their true locations; generated
        # nodes are filled in by fix_missing_locations at module level
        return [_guard_stmt(n) for n in names] + [tdef, fdef, final]

    def _rewrite_if_returns(self, node, body_esc, else_esc):
        """Only the tail-return-in-both-branches shape converts; anything
        else is left as written (fine for Python predicates; a traced
        predicate then raises via explain_trace_error)."""
        both_tail = (
            node.body and node.orelse
            and isinstance(node.body[-1], ast.Return)
            and isinstance(node.orelse[-1], ast.Return)
            and body_esc.returns == [node.body[-1]]
            and else_esc.returns == [node.orelse[-1]])
        if not both_tail:
            return node
        i = self._next()
        tname, fname = f"{_PREFIX}true_{i}", f"{_PREFIX}false_{i}"

        def mk(stmts, fn_name):
            last = stmts[-1]
            value = last.value if last.value is not None \
                else ast.Constant(value=None)
            body = list(stmts[:-1]) + [
                ast.Return(value=ast.Tuple(elts=[value], ctx=ast.Load()))]
            return _def(fn_name, [], body)

        tdef = mk(node.body, tname)
        fdef = mk(node.orelse, fname)
        call = ast.Call(
            func=_jst_attr("convert_ifelse"),
            args=[node.test, _name(tname, ast.Load()),
                  _name(fname, ast.Load()),
                  ast.Tuple(elts=[], ctx=ast.Load())],
            keywords=[])
        final = ast.Return(value=ast.Subscript(
            value=call, slice=ast.Constant(value=0), ctx=ast.Load()))
        return [tdef, fdef, final]

    # --- while ------------------------------------------------------------
    def visit_While(self, node):
        self.generic_visit(node)
        esc = _escapes(node.body, skip_loop_ctl=False)
        if esc.returns or esc.breaks or node.orelse:
            # break/continue/return/else: leave as written (Python-pred
            # loops still work; traced preds raise a clear error)
            return node
        # loop carries = names the body rebinds (anything only READ — in
        # the test or the body — stays constant and rides the closure;
        # globals/builtins in the test therefore never become carries)
        names = sorted(_assigned(node.body))
        i = self._next()
        cname, bname = f"{_PREFIX}while_cond_{i}", f"{_PREFIX}while_body_{i}"
        cdef = _def(cname, names, [ast.Return(value=node.test)])
        bdef = _def(bname, names,
                    list(node.body) + [ast.Return(
                        value=_tuple(names, ast.Load()))])
        call = ast.Call(
            func=_jst_attr("convert_while"),
            args=[_name(cname, ast.Load()), _name(bname, ast.Load()),
                  _tuple(names, ast.Load())],
            keywords=[])
        if names:
            final = ast.Assign(targets=[_tuple(names, ast.Store())],
                               value=call)
        else:
            final = ast.Expr(value=call)
        return [_guard_stmt(n) for n in names] + [cdef, bdef, final]


# ---------------------------------------------------------------------------
# function-level conversion
# ---------------------------------------------------------------------------

class _HasControlFlow(ast.NodeVisitor):
    def __init__(self):
        self.found = False
        self.has_global = False

    def visit_If(self, node):
        self.found = True
        self.generic_visit(node)

    visit_While = visit_If

    def visit_Global(self, node):
        self.has_global = True

    visit_Nonlocal = visit_Global


_CACHE: dict = {}


def convert_to_static(fn):
    """Return ``fn`` with tensor-dependent ``if``/``while`` rewritten to
    torch.cond / while_loop calls. Bound methods stay bound; functions whose
    source is unavailable (C code, lambdas, REPL) or that contain no
    control flow are returned unchanged."""
    bound_self = getattr(fn, "__self__", None)
    func = fn.__func__ if bound_self is not None else fn
    if not isinstance(func, types.FunctionType):
        return fn
    cached = _CACHE.get(func)
    if cached is None:
        cached = _convert_function(func)
        _CACHE[func] = cached
    if cached is func:
        return fn
    if bound_self is not None:
        return types.MethodType(cached, bound_self)
    return cached


def _convert_function(func):
    try:
        src = textwrap.dedent(inspect.getsource(func))
        tree = ast.parse(src)
    except (OSError, TypeError, SyntaxError, IndentationError):
        return func
    if not tree.body or not isinstance(tree.body[0], ast.FunctionDef):
        return func
    fdef = tree.body[0]
    probe = _HasControlFlow()
    probe.visit(fdef)
    if not probe.found or probe.has_global:
        return func  # nothing to rewrite (or global/nonlocal: unsafe)

    fdef.decorator_list = []  # don't re-run @to_static/@wraps on exec
    _ControlFlowTransformer().visit(fdef)

    # the runtime helpers (``_JST``) reach the rewritten body as a closure
    # variable of a factory, beside the original's own free variables: a
    # closure, unlike a global, is found by TorchDynamo too (it traces a
    # while_loop's body)
    freevars = func.__code__.co_freevars
    factory_name = _PREFIX + "factory__"
    factory = _def(factory_name, list(freevars) + [_JST],
                   [fdef, ast.Return(value=_name(fdef.name, ast.Load()))])
    ast.copy_location(factory, fdef)
    module = ast.Module(body=[factory], type_ignores=[])
    ast.fix_missing_locations(module)
    import logging
    logger = logging.getLogger("paddle_tpu_torch.dy2static")
    if logger.isEnabledFor(logging.DEBUG):
        # jit.set_code_level/set_verbosity surface the rewritten source
        logger.debug("dy2static transformed %s:\n%s", func.__qualname__,
                     ast.unparse(fdef))
    try:
        lineno = func.__code__.co_firstlineno
        ast.increment_lineno(module, lineno - 1)
        code = compile(module, func.__code__.co_filename, "exec")
    except SyntaxError:
        return func

    from . import dy2static as _self
    namespace = dict(func.__globals__)
    exec(code, namespace)
    cells = [c.cell_contents for c in (func.__closure__ or ())]
    new = namespace[factory_name](*cells, _self)
    new.__defaults__ = func.__defaults__
    new.__kwdefaults__ = func.__kwdefaults__
    functools.update_wrapper(new, func)
    new.__wrapped__ = func
    return new
