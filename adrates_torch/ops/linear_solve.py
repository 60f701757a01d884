"""Custom linear solves: the port's counterpart of ``lax.custom_linear_solve``
at the JAX package's two solve sites.

- :func:`chain_solve` / :func:`chain_solve_t`: the OIS bootstrap's pv01
  system (I - A) x = b and its transpose, A x = where(prev >= 0,
  x[prev], 0) / denom over a point plan's previous-point links
  (``adrates_tpu/ops/bootstrap.py:291-352``). The solves run on K4
  ``pv01_solve`` and K5 ``pv01_solve_t`` (``ops/kernels.py``,
  ``csrc/pv01_solve.cu``): a CUDA tensor launches the kernel, a CPU
  tensor runs its plain K-sweep.
- :func:`neumann_solve`: the XCCY pillar system (I - A) x = b with a
  dense strictly lower [S, S] A, by Neumann doubling in ``torch.matmul``
  (``adrates_tpu/ops/xccy_bootstrap.py:160-203``).

Each is a ``torch.autograd.Function`` whose derivatives are solves, as
the JAX package's are: ``backward`` is the transpose solve plus
elementwise terms (b̄ = (I - A)⁻ᵀ x̄, d̄enom = -b̄ ⊙ A(x) / denom; for
the dense solve Ā = b̄ xᵀ), ``jvp`` one more forward solve (dx = (I -
A)⁻¹ (db + dA·x)), and ``vmap`` folds every batch dimension into the
rows (a ctypes launch cannot see a batched tensor). ``backward`` and
``jvp`` apply these Functions again, so every AD level is one more solve
however deep the plan, and orders compose.

Forward mode: at most ONE level. ``torch.func`` runs a Function's
``jvp`` rule where an outer forward-mode level does not record it, so a
solve under two forward levels (``jacfwd(jacfwd(f))``, ``jvp`` over
``jvp``) would lose the cross terms and return a wrong number. Every
solve raises :class:`LibError` there instead. Compose reverse levels
inside the one forward level: ``jacfwd(jacrev(jacrev(f)))`` for a third
order, and :func:`jvp_by_vjp` for a directional derivative inside a
``jvp``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import vjp
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..utils.error import LibError
from . import kernels


def forward_levels() -> int:
    """The number of forward-mode (jvp) transforms active at the call."""
    from torch._C._functorch import TransformType
    from torch._functorch.pyfunctorch import \
        retrieve_all_functorch_interpreters
    return sum(i.key() == TransformType.Jvp
               for i in retrieve_all_functorch_interpreters())


def _one_forward_level(what: str) -> None:
    n = forward_levels()
    if n > 1:
        raise LibError(
            f"{what} under {n} forward-mode levels: a solve's jvp rule is "
            f"not differentiated by an outer forward level, so the result "
            f"would be wrong. Compose at most one forward level over a "
            f"solve (jacfwd(jacrev(jacrev(f))), or jvp_by_vjp inside a "
            f"jvp).")


def _front(t: torch.Tensor, dim, size: int) -> torch.Tensor:
    """``t`` with its vmapped dimension first (expanded if it has none)."""
    if dim is None:
        return t.expand((size,) + t.shape)
    return t.movedim(dim, 0)


# ---------------------------------------------------------------------------
# the OIS pv01 chain
# ---------------------------------------------------------------------------


def _chain(rhs, denom, tab, transpose):
    _one_forward_level("chain_solve_t" if transpose else "chain_solve")
    if rhs.shape != denom.shape:
        rhs, denom = torch.broadcast_tensors(rhs, denom)
    return _ChainSolve.apply(rhs, denom, tab, transpose)


class _ChainSolve(torch.autograd.Function):
    """x = (I - A)^-1 rhs, or with ``transpose`` y = (I - A)^-T rhs, for
    ``rhs`` and ``denom`` of one shape [..., *tab.shape]."""

    @staticmethod
    def forward(rhs, denom, tab, transpose):
        P = rhs.shape[-1]
        solve = kernels.pv01_solve_t if transpose else kernels.pv01_solve
        return solve(rhs.reshape(-1, P).contiguous(),
                     denom.reshape(-1, P).contiguous(),
                     tab).reshape(rhs.shape)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, denom, tab, transpose = inputs
        ctx.save_for_backward(denom, output)
        ctx.save_for_forward(denom, output)
        ctx.tab = tab
        ctx.transpose = transpose

    @staticmethod
    def backward(ctx, gout):
        denom, out = ctx.saved_tensors
        tab = ctx.tab
        grhs = _chain(gout, denom, tab, not ctx.transpose)
        if ctx.transpose:
            # y = (I - A')^-1 c: <ȳ, dA' y> = <dA c̄, y>
            gden = -out * kernels.chain_matvec(grhs, denom, tab) / denom
        else:
            gden = -grhs * kernels.chain_matvec(out, denom, tab) / denom
        return grhs, gden, None, None

    @staticmethod
    def jvp(ctx, drhs, dden, _tab, _transpose):
        denom, out = ctx.saved_tensors
        tab = ctx.tab
        rhs = drhs
        if dden is not None:
            if ctx.transpose:
                extra = kernels.chain_matvec_t(-out * dden / denom, denom,
                                               tab)
            else:
                extra = -kernels.chain_matvec(out, denom, tab) * dden / denom
            rhs = extra if rhs is None else rhs + extra
        if rhs is None:
            return torch.zeros_like(out)
        return _chain(rhs, denom, tab, ctx.transpose)

    @staticmethod
    def vmap(info, in_dims, rhs, denom, tab, transpose):
        rhs = _front(rhs, in_dims[0], info.batch_size)
        denom = _front(denom, in_dims[1], info.batch_size)
        return _chain(rhs, denom, tab, transpose), 0


def chain_solve(b: torch.Tensor, denom: torch.Tensor,
                tab: kernels.ChainTables) -> torch.Tensor:
    """x = (I - A)^-1 b with (A x)_i = x[prev_i] / denom_i (0 at a root):
    ``b`` and ``denom`` broadcast to [..., *tab.shape]; a stacked plan's
    curve g is the row [..., g, :]."""
    return _chain(b, denom, tab, False)


def chain_solve_t(c: torch.Tensor, denom: torch.Tensor,
                  tab: kernels.ChainTables) -> torch.Tensor:
    """y = (I - A)^-T c, the transpose of :func:`chain_solve`."""
    return _chain(c, denom, tab, True)


# ---------------------------------------------------------------------------
# the XCCY pillar system
# ---------------------------------------------------------------------------


def _doubling(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(I + A)(I + A^2)(I + A^4)... b = sum_{k < 2^m} A^k b, exact once
    2^m >= S since A^S = 0; the powers squared once, then one matvec
    each."""
    S = b.shape[-1]
    m_steps = max(int(np.ceil(np.log2(max(S, 2)))), 1)
    x, Mk = b, A
    for k in range(m_steps):
        x = x + (Mk @ x.unsqueeze(-1)).squeeze(-1)
        if k + 1 < m_steps:
            Mk = Mk @ Mk
    return x


def _neumann(A, b):
    _one_forward_level("neumann_solve")
    lead = torch.broadcast_shapes(A.shape[:-2], b.shape[:-1])
    if A.shape[:-2] != lead:
        A = A.expand(lead + A.shape[-2:])
    if b.shape[:-1] != lead:
        b = b.expand(lead + b.shape[-1:])
    return _NeumannSolve.apply(A, b)


class _NeumannSolve(torch.autograd.Function):
    """x = (I - A)^-1 b for a nilpotent A [..., S, S] (index <= S) and
    b [..., S] of the same leading shape."""

    @staticmethod
    def forward(A, b):
        return _doubling(A, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        A, _ = inputs
        ctx.save_for_backward(A, output)
        ctx.save_for_forward(A, output)

    @staticmethod
    def backward(ctx, gx):
        A, x = ctx.saved_tensors
        gb = _neumann(A.mT, gx)
        return gb.unsqueeze(-1) * x.unsqueeze(-2), gb

    @staticmethod
    def jvp(ctx, dA, db):
        A, x = ctx.saved_tensors
        rhs = db
        if dA is not None:
            extra = (dA @ x.unsqueeze(-1)).squeeze(-1)
            rhs = extra if rhs is None else rhs + extra
        if rhs is None:
            return torch.zeros_like(x)
        return _neumann(A, rhs)

    @staticmethod
    def vmap(info, in_dims, A, b):
        A = _front(A, in_dims[0], info.batch_size)
        b = _front(b, in_dims[1], info.batch_size)
        return _neumann(A, b), 0


def neumann_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x = (I - A)^-1 b for a strictly lower (nilpotent) A [..., S, S],
    b [..., S], leading shapes broadcast. Each solve (the forward one,
    and each transpose or tangent solve AD asks for) squares its own
    powers of A where AD does not record them; the JAX package shares
    one squaring chain across them, so a derivative solve here runs
    ceil(log2 S) - 1 more [S, S] products than there."""
    return _neumann(A, b)


# ---------------------------------------------------------------------------
# a jvp without a forward-mode level
# ---------------------------------------------------------------------------


def jvp_by_vjp(f, x: torch.Tensor, s: torch.Tensor):
    """(f(x), J s) for the jacobian J of ``f`` at ``x``, by two reverse
    passes: J s is the vjp of the linear map u -> Jᵀ u. No forward-mode
    level is opened, so a ``jvp`` over it passes a solve one forward
    level only. ``f`` may return a pytree of tensors."""
    out, pull = vjp(f, x)
    flat, spec = tree_flatten(out)

    def pullback(*u):
        return pull(tree_unflatten(list(u), spec))[0]

    _, push = vjp(pullback, *[torch.zeros_like(o) for o in flat])
    return out, tree_unflatten(list(push(s)), spec)
