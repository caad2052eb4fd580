"""Moore-Penrose pseudo-inverse iteration of the Nystrom attention.

Counterpart of ``mirror_tpu/ops/pinv_pallas.py::moore_penrose_pinv_pallas``.
The global scale is reduced by torch here, outside the kernel, as the TPU
package leaves it to XLA. On a CUDA tensor the iterations run
``csrc/pinv.cu``; on a CPU tensor :func:`pinv_iterations_ref`: the op
``mirror::pinv`` (:func:`pinv_op`), which both Functions' forwards and an
exported program call.

On the card the iterations are launch sequences of one batched GEMM
(``mirror_pinv_gemm``, 4 launches a forward iteration, 12 a backward one)
and three helpers: :func:`pinv_sequence` and :func:`pinv_exact_bwd_sequence`,
which take a launcher, :data:`CUDA_LAUNCHER` for the card. Each C entry has
a plain version here (:func:`gemm_ref`, :func:`init_ref`,
:func:`eye_axpby_ref`, :func:`bwd_finish_ref`, gathered in
:data:`PLAIN_LAUNCHER`) so the CPU tests can run the same sequences; no
path of the program passes it. Each GEMM launch is counted as
``pinv_gemm``.

The scale is global over the batch, as the JAX package's is over its data
mesh: under a process group of several ranks :class:`GlobalScale` reduces
it over every rank's block.

Gradients:

- ``grad="implicit"`` (the train step's default): :class:`PinvImplicit`,
  the implicit-function gradient -z^T (g z^T) of the converged inverse, two
  matrix products in the compute dtype; the TPU package computes it outside
  any kernel too (pinv_pallas.py:223-233). The scale gets no gradient.
- ``grad="exact"``: :class:`PinvExact`, the gradient through the
  iterations (TPU kernel 2b, ``pinv_pallas.py:171``): the backward kernel
  of ``csrc/pinv.cu`` on the card, :func:`pinv_exact_bwd_ref` on the CPU,
  with the Pallas body's rounding points. The scale is an input of the
  Function, computed by :func:`global_scale` outside it, so its gradient
  reaches x through the two ``max()`` reductions by autograd, as the TPU
  package leaves it to XLA (pinv_pallas.py:259-262).
"""

from types import SimpleNamespace

import torch

from ..parallel import distributed
from . import _common

KERNEL = "moore_penrose_pinv"
KERNEL_BWD = "moore_penrose_pinv_bwd"
KERNEL_GEMM = "pinv_gemm"  # each launch of the batched GEMM of both


def global_scale(x: torch.Tensor, over_ranks: bool = True) -> torch.Tensor:
    """max(rowsum|x|) * max(colsum|x|) over the WHOLE [b, h, m, m] tensor
    (the reference's quirk), as an fp32 scalar tensor on x's device. Under
    a process group of several ranks the whole tensor is the global
    batch's, as on the JAX package's data mesh: :class:`GlobalScale`;
    ``over_ranks=False`` keeps it this rank's, for an x that every rank
    holds alike (context parallelism's landmark matrix, which a reduction
    over the ranks would count once a rank)."""
    if over_ranks and distributed.multi():
        return GlobalScale.apply(x)
    abs_x = x.abs()
    col = abs_x.sum(-1)
    row = abs_x.sum(-2)
    return (col.max() * row.max()).float()


class GlobalScale(torch.autograd.Function):
    """:func:`global_scale` over every rank's block of the batch: the two
    maxima all-reduced with MAX (one collective), their product rounded as
    one process rounds it. The backward (the exact pinv gradient; the
    implicit one takes none) sums the incoming ds over the ranks, since
    each rank's loss reaches the one shared scale, and routes it as
    autograd through ``max()`` does on one process: evenly over every
    element that holds the maximum, counted over all ranks, so the one tie
    rule is the same on every rank and the ranks without the maximum get
    none."""

    @staticmethod
    def forward(ctx, x):
        abs_x = x.detach().abs()
        col, row = abs_x.sum(-1), abs_x.sum(-2)
        maxima = distributed.all_reduce(torch.stack([col.max(), row.max()]), "max")
        cmax, rmax = maxima.to(x.dtype).unbind()
        ctx.save_for_backward(x, col, row, cmax, rmax)
        return (cmax * rmax).float()

    @staticmethod
    def backward(ctx, ds):
        x, col, row, cmax, rmax = ctx.saved_tensors
        at_c, at_r = col == cmax, row == rmax
        total = distributed.all_reduce(torch.stack(
            [ds.float().reshape(()), at_c.sum().float(), at_r.sum().float()]))
        g = total[0].to(x.dtype)
        g_col = torch.where(at_c, g * rmax / total[1].to(x.dtype), 0.0).to(x.dtype)
        g_row = torch.where(at_r, g * cmax / total[2].to(x.dtype), 0.0).to(x.dtype)
        return torch.sgn(x) * (g_col.unsqueeze(-1) + g_row.unsqueeze(-2))


def _dot(a, b):
    """a @ b with fp32 accumulation, rounded to a's dtype."""
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def _dot_nt(a, b):
    """a @ b^T with fp32 accumulation, rounded to a's dtype."""
    return torch.matmul(a.float(), b.float().transpose(-1, -2)).to(a.dtype)


def _dot_tn(a, b):
    """a^T @ b with fp32 accumulation, rounded to a's dtype."""
    return torch.matmul(a.float().transpose(-1, -2), b.float()).to(a.dtype)


def pinv_iterations_ref(x: torch.Tensor, s: torch.Tensor, iters: int = 6):
    """Plain version, with the TPU kernel's rounding points (_iter_body)."""
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    z = (x.transpose(-1, -2).float() / s).to(x.dtype)
    for _ in range(iters):
        xz = _dot(x, z)
        t1 = 7.0 * eye - xz
        t3 = 15.0 * eye - _dot(xz, t1)
        a = 13.0 * eye - _dot(xz, t3)
        z = (0.25 * _dot(z, a)).to(z.dtype)
    return z


# the batched GEMM's operand layouts and epilogues (csrc/pinv.cu)
_NN, _NT, _TN = 0, 1, 2
_EYE, _ADD, _ACC32 = 0, 1, 2


def _launch_gemm(a, b, c=None, c2=None, prev=None, acc=None, layout=_NN, epilogue=_EYE, c0=0.0,
                 c1=1.0, d0=0.0, d1=0.0):
    """One launch of the batched [m, m] GEMM P = op(a) op(b) (``mirror_pinv_gemm``):
    EYE writes c = bf16(c0 I + c1 bf16(P)) (and c2 = bf16(d0 I + d1 c)), ADD
    c = bf16(prev + c1 bf16(P)), ACC32 acc += P in fp32; bf16 there stands
    for a's dtype, the compute type."""
    m = a.shape[-1]
    ptrs = [t.data_ptr() if t is not None else None for t in (a, b, c, c2, prev, acc)]
    _common.launch("mirror_pinv_gemm", *ptrs, a.numel() // (m * m), m, m, m, layout, epilogue,
                   c0, c1, d0, d1, _common.type_code(a.dtype))
    _common.count_launch(_common.instance(KERNEL_GEMM, a.dtype))


def gemm_ref(a, b, c=None, c2=None, prev=None, acc=None, layout=_NN, epilogue=_EYE, c0=0.0,
             c1=1.0, d0=0.0, d1=0.0):
    """Plain version of one ``mirror_pinv_gemm`` launch, on [..., m, m]
    tensors, writing c (and c2) or acc in place: P = op(a) op(b) in fp32
    (layout NN a b, NT a b^T, TN a^T b); EYE c = bf16(c0 I + c1 bf16(P)) and,
    given c2, c2 = bf16(d0 I + d1 c); ADD c = bf16(prev + c1 bf16(P)), prev
    may be c itself; ACC32 acc += P in fp32, unrounded."""
    a32 = a.float().reshape(-1, *a.shape[-2:])
    b32 = b.float().reshape(-1, *b.shape[-2:])
    if layout == _TN:
        a32 = a32.transpose(-1, -2)
    if layout == _NT:
        b32 = b32.transpose(-1, -2)
    p = torch.matmul(a32, b32)  # [bh, M, N]
    if epilogue == _ACC32:
        acc.view(p.shape).add_(p)
        return
    dt = c.dtype
    eye = torch.eye(p.shape[-2], p.shape[-1], device=p.device)
    start = prev.float().view(p.shape) if epilogue == _ADD else c0 * eye
    out = (start + c1 * p.to(dt).float()).to(dt)
    c.view(p.shape).copy_(out)
    if epilogue == _EYE and c2 is not None:
        c2.view(p.shape).copy_((d0 * eye + d1 * out.float()).to(dt))


def _launch_init(x, s, z):
    m = x.shape[-1]
    _common.launch("mirror_pinv_init", x.data_ptr(), s.data_ptr(), z.data_ptr(),
                   x.numel() // (m * m), m, _common.type_code(x.dtype))


def init_ref(x, s, z):
    """Plain ``mirror_pinv_init``: z = bf16(x^T / s), in place."""
    z.copy_((x.transpose(-1, -2).float() / s).to(z.dtype).reshape(z.shape))


def _launch_eye_axpby(inp, out, c0, c1):
    m = inp.shape[-1]
    _common.launch("mirror_pinv_eye_axpby", inp.data_ptr(), out.data_ptr(),
                   inp.numel() // (m * m), m, c0, c1, _common.type_code(inp.dtype))


def eye_axpby_ref(inp, out, c0, c1):
    """Plain ``mirror_pinv_eye_axpby``: out = bf16(c0 I + c1 inp), in place."""
    eye = torch.eye(inp.shape[-1], device=inp.device)
    out.copy_((c0 * eye + c1 * inp.float()).to(out.dtype).reshape(out.shape))


def _launch_bwd_finish(gx32, gz, z0, s, gx, gs_partial):
    m = gz.shape[-1]
    _common.launch("mirror_pinv_bwd_finish", gx32.data_ptr(), gz.data_ptr(), z0.data_ptr(),
                   s.data_ptr(), gx.data_ptr(), gs_partial.data_ptr(), gz.numel() // (m * m), m,
                   _common.type_code(gz.dtype))


def bwd_finish_ref(gx32, gz, z0, s, gx, gs_partial):
    """Plain ``mirror_pinv_bwd_finish``: gx = bf16(gx32 + gz^T / s) and
    gs_partial[bh] = -sum(gz * z0) / s over each [m, m] matrix, in place."""
    m = gz.shape[-1]
    gx.copy_((gx32 + gz.transpose(-1, -2).float() / s).to(gx.dtype))
    prod = gz.float().reshape(-1, m, m) * z0.float().reshape(-1, m, m)
    gs_partial.copy_(-prod.sum(dim=(-1, -2)) / s)


# The C entries the launch sequences below call, and their plain versions.
# The wrappers pass CUDA_LAUNCHER; the CPU tests pass PLAIN_LAUNCHER to run
# the same sequences through the plain versions.
CUDA_LAUNCHER = SimpleNamespace(gemm=_launch_gemm, init=_launch_init,
                                eye_axpby=_launch_eye_axpby, bwd_finish=_launch_bwd_finish)
PLAIN_LAUNCHER = SimpleNamespace(gemm=gemm_ref, init=init_ref, eye_axpby=eye_axpby_ref,
                                 bwd_finish=bwd_finish_ref)


def _iterations(x, s, iters, slots, ops, last_z=True):
    """The iterations as launches: z0 = bf16(x^T / s) into ``slots(0)[0]``;
    at each t, with (z, xz, t3, a) = ``slots(t)``, xz = x z (and
    t1 = 7I - xz in a scratch buffer), t3 = 15I - xz t1, a = 13I - xz t3 and
    z' = 0.25 z a into ``slots(t + 1)[0]`` (the last one only if ``last_z``)."""
    ops.init(x, s, slots(0)[0])
    t1 = torch.empty_like(x)
    for t in range(iters):
        z, xz, t3, a = slots(t)
        ops.gemm(x, z, xz, t1, d0=7.0, d1=-1.0)
        ops.gemm(xz, t1, t3, c0=15.0, c1=-1.0)
        ops.gemm(xz, t3, a, c0=13.0, c1=-1.0)
        if last_z or t + 1 < iters:
            ops.gemm(z, a, slots(t + 1)[0], c1=0.25)


def pinv_sequence(x: torch.Tensor, s: torch.Tensor, iters: int, ops=CUDA_LAUNCHER):
    """The forward as the card runs it: 4 GEMM launches an iteration,
    through ``ops`` (:data:`CUDA_LAUNCHER` or :data:`PLAIN_LAUNCHER`)."""
    zs = (torch.empty_like(x), torch.empty_like(x))  # z_t and z_{t+1} alternate
    xz, t3, a = (torch.empty_like(x) for _ in range(3))
    _iterations(x, s, iters, lambda t: (zs[t % 2], xz, t3, a), ops)
    return zs[iters % 2]


@torch.library.custom_op(f"{_common.OP_NAMESPACE}::pinv", mutates_args=(), device_types="cpu")
def pinv_op(x: torch.Tensor, s: torch.Tensor, iters: int) -> torch.Tensor:
    """``mirror::pinv``: the iterations from the scale ``s`` (an fp32
    scalar tensor on x's device); on the CPU :func:`pinv_iterations_ref`."""
    return pinv_iterations_ref(x, s, iters)


@pinv_op.register_kernel("cuda")
def _pinv_kernel(x: torch.Tensor, s: torch.Tensor, iters: int) -> torch.Tensor:
    b, h, m, _ = x.shape
    _common.check_kernel_input("x", x, (b, h, m, m), x.dtype)
    if s.device != x.device or s.dtype != torch.float32 or s.numel() != 1:
        raise ValueError(f"s: {s.dtype} {tuple(s.shape)} on {s.device}, the kernel takes "
                         f"an fp32 scalar on {x.device}")
    z = pinv_sequence(x, s, iters)
    _common.count_launch(_common.instance(KERNEL, x.dtype))
    return z


@pinv_op.register_fake
def _pinv_fake(x, s, iters):
    return torch.empty_like(x)


def _step_ref(x, z, eye, xz=None):
    """One iteration's (z, B = x z, t3, a), B recomputed unless given."""
    xz = _dot(x, z) if xz is None else xz
    t3 = 15.0 * eye - _dot(xz, 7.0 * eye - xz)
    return z, xz, t3, 13.0 * eye - _dot(xz, t3)


def _sweep_ref(x, s, g, z0, eye, steps):
    """The reverse sweep over ``steps``, (z_t, B_t, t3_t, a_t) from the last
    iteration back, then the finish: (gx in x's dtype, gs an fp32 scalar)."""
    dt = x.dtype
    gz = g.to(dt)
    gx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for z, b_, t3, a in steps:
        t1 = 7.0 * eye - b_
        gt4 = -(0.25 * _dot_tn(z, gz))
        gz_next = 0.25 * _dot_nt(gz, a)
        gb = _dot_nt(gt4, t3)
        gt2 = -_dot_tn(b_, gt4)
        gb = gb + _dot_nt(gt2, t1)
        gb = gb - _dot_tn(b_, gt2)
        gx = gx + torch.matmul(gb.float(), z.float().transpose(-1, -2))
        gz = (gz_next + _dot_tn(x, gb)).to(dt)
    gx = gx + gz.transpose(-1, -2).float() / s
    gs = -(gz.float() * z0.float()).sum(dim=(-1, -2)) / s
    return gx.to(dt), gs.sum()


def _replay_ref(x, s, iters, eye):
    """z0 and the replay's (z_t, B_t, t3_t, a_t) for each t."""
    z0 = z = (x.transpose(-1, -2).float() / s).to(x.dtype)
    steps = []
    for _ in range(iters):
        steps.append(_step_ref(x, z, eye))
        z = (0.25 * _dot(z, steps[-1][3])).to(x.dtype)
    return z0, steps


def pinv_exact_bwd_ref(x: torch.Tensor, s: torch.Tensor, g: torch.Tensor, iters: int = 6):
    """Plain version of the exact backward (_bwd_kernel of the TPU
    package, its rounding points): replay the forward stashing z_t, B_t =
    x z_t, t3_t, A_t, then sweep back. Returns (gx in x's dtype, gs an fp32
    scalar)."""
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    z0, steps = _replay_ref(x, s, iters, eye)
    return _sweep_ref(x, s, g, z0, eye, reversed(steps))


def pinv_exact_bwd_stash_ref(x: torch.Tensor, s: torch.Tensor, g: torch.Tensor,
                             iters: int = 6, stash: int = 1):
    """Plain version of the exact backward that keeps z_t (``stash`` 1) or
    z_t and B_t = x z_t (``stash`` 2) from the replay and recomputes the
    rest in the sweep, with the products and rounding points of
    ``scripts/exp_pinv_stash.py::_bwd_kernel_stash``. The recomputed
    products are the replay's, so the result is :func:`pinv_exact_bwd_ref`'s."""
    if stash not in (1, 2):
        raise ValueError(f"stash must be 1 (z) or 2 (z and x z), got {stash}")
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    z0, steps = _replay_ref(x, s, iters, eye)
    kept = [(z, xz if stash == 2 else None) for z, xz, _, _ in steps]
    return _sweep_ref(x, s, g, z0, eye, (_step_ref(x, z, eye, xz) for z, xz in reversed(kept)))


def pinv_exact_bwd_sequence(x: torch.Tensor, s: torch.Tensor, g: torch.Tensor, iters: int,
                            stash: int = 4, ops=CUDA_LAUNCHER):
    """The replay and the reverse sweep as the card runs them: 4 + 8
    launches of the batched GEMM per iteration (the replay's last z
    product, which the sweep never reads, skipped), through ``ops``. The
    replay stashes ``stash`` of (z_t, x z_t, t3_t, a_t) per iteration in
    device memory for the call: all 4 (kernel 2b), or z_t (1) or z_t and
    x z_t (2), as the probe ``scripts/exp_pinv_stash.py`` asks; the sweep
    then recomputes the rest with the replay's launches (3 or 2 more GEMMs
    per iteration), so every variant gives the same gradient. Returns (gx
    in x's dtype, gs an fp32 scalar)."""
    if stash not in (1, 2, 4):
        raise ValueError(f"stash must be 1, 2 or 4, got {stash}")
    m = x.shape[-1]
    bh = x.numel() // (m * m)
    kept = x.new_empty(iters, stash, bh, m, m)  # the first `stash` of (z, xz, t3, a) for each t
    rest = [torch.empty_like(x) for _ in range(4 - stash)]  # the others, recomputed
    z0 = kept[0, 0] if iters else torch.empty_like(x)

    def slots(t):
        return (*kept[t], *rest) if iters else (z0,)

    _iterations(x, s, iters, slots, ops, last_z=False)

    gz = g.clone()
    gz_next, gt4, gt2, gb = (torch.empty_like(x) for _ in range(4))
    gx32 = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    t1 = torch.empty_like(x)
    gemm = ops.gemm
    for t in range(iters - 1, -1, -1):
        z, xz, t3, a = slots(t)
        if stash == 1:  # xz = x z and t1 = 7I - xz in one launch
            gemm(x, z, xz, t1, d0=7.0, d1=-1.0)
        else:
            ops.eye_axpby(xz, t1, 7.0, -1.0)
        if stash < 4:
            gemm(xz, t1, t3, c0=15.0, c1=-1.0)
            gemm(xz, t3, a, c0=13.0, c1=-1.0)
        gemm(z, gz, gt4, layout=_TN, c1=-0.25)  # gt4 = -gA = -0.25 z^T gz
        gemm(gz, a, gz_next, layout=_NT, c1=0.25)  # gz' = 0.25 gz a^T
        gemm(gt4, t3, gb, layout=_NT)  # gb = gt4 t3^T
        gemm(xz, gt4, gt2, layout=_TN, c1=-1.0)  # gt2 = -B^T gt4
        gemm(gt2, t1, gb, prev=gb, layout=_NT, epilogue=_ADD)  # gb += gt2 t1^T
        gemm(xz, gt2, gb, prev=gb, layout=_TN, epilogue=_ADD, c1=-1.0)  # gb -= B^T gt2
        gemm(gb, z, acc=gx32, layout=_NT, epilogue=_ACC32)  # gx += gb z^T (fp32)
        gemm(x, gb, gz, prev=gz_next, layout=_TN, epilogue=_ADD)  # gz = gz' + x^T gb
    gx = torch.empty_like(x)
    gs = torch.empty(bh, dtype=torch.float32, device=x.device)
    ops.bwd_finish(gx32, gz, z0, s, gx, gs)
    return gx, gs.sum()


def _pinv_exact_bwd_kernel(x: torch.Tensor, s: torch.Tensor, g: torch.Tensor, iters: int,
                           stash: int = 4):
    """:func:`pinv_exact_bwd_sequence` on the card."""
    b, h, m, _ = x.shape
    _common.check_kernel_input("x", x, (b, h, m, m), x.dtype)
    _common.check_kernel_input("g", g, (b, h, m, m), x.dtype)
    gx, gs = pinv_exact_bwd_sequence(x, s, g, iters, stash)
    _common.count_launch(_common.instance(
        KERNEL_BWD if stash == 4 else f"{KERNEL_BWD}_stash{stash}", x.dtype))
    return gx, gs


class PinvImplicit(torch.autograd.Function):
    """z = pinv(x) by the iterations; dL/dx = -z^T (g z^T)."""

    @staticmethod
    def forward(ctx, x, iters: int, over_ranks: bool = True):
        z = pinv_op(x, global_scale(x.detach(), over_ranks), iters)
        ctx.save_for_backward(z)
        return z

    @staticmethod
    def backward(ctx, g):
        (z,) = ctx.saved_tensors
        zt = z.transpose(-1, -2)
        return -torch.matmul(zt, torch.matmul(g.to(z.dtype), zt)), None, None


class PinvImplicitRef(PinvImplicit):
    """:class:`PinvImplicit` over the plain iterations on any device."""

    @staticmethod
    def forward(ctx, x, iters: int, over_ranks: bool = True):
        z = pinv_iterations_ref(x, global_scale(x.detach(), over_ranks), iters)
        ctx.save_for_backward(z)
        return z


class PinvExact(torch.autograd.Function):
    """z = pinv(x) by the iterations from the scale s; the backward returns
    dL/dx through the iterations and dL/ds (kernel 2b on the card). With
    ``stash`` 1 or 2 the backward keeps less of the replay and recomputes
    the rest (the probe ``exp_pinv_stash``'s variants): the same gradient."""

    @staticmethod
    def forward(ctx, x, s, iters: int, stash: int = 4):
        z = pinv_op(x, s, iters)
        ctx.save_for_backward(x, s)
        ctx.iters, ctx.stash = iters, stash
        return z

    @staticmethod
    def backward(ctx, g):
        x, s = ctx.saved_tensors
        g = _common.grad_or_zeros(g, x)
        if _common.on_cuda(x, s):
            gx, gs = _pinv_exact_bwd_kernel(x, s, g, ctx.iters, ctx.stash)
        elif ctx.stash == 4:
            gx, gs = pinv_exact_bwd_ref(x, s, g, ctx.iters)
        else:
            gx, gs = pinv_exact_bwd_stash_ref(x, s, g, ctx.iters, ctx.stash)
        return gx, gs.to(s.dtype), None, None


def moore_penrose_pinv(x: torch.Tensor, iters: int = 6, grad: str = "implicit",
                       over_ranks: bool = True) -> torch.Tensor:
    """Iterative pseudo-inverse of [b, h, m, m] matrices:
    z <- 0.25 z (13I - xz (15I - xz (7I - xz))), z0 = x^T / global_scale(x)
    (``over_ranks``: :func:`global_scale`'s)."""
    if grad == "implicit":
        return PinvImplicit.apply(x, iters, over_ranks)
    if grad != "exact":
        raise ValueError(f"pinv grad must be 'exact' or 'implicit', got {grad!r}")
    return PinvExact.apply(x, global_scale(x, over_ranks), iters)


def moore_penrose_pinv_stash(x: torch.Tensor, iters: int = 6, stash: int = 1) -> torch.Tensor:
    """:func:`moore_penrose_pinv` with the exact gradient, its backward
    keeping ``stash`` of the four replay products per iteration (4 is
    ``grad="exact"``)."""
    return PinvExact.apply(x, global_scale(x), iters, stash)


def moore_penrose_pinv_ref(x: torch.Tensor, iters: int = 6, grad: str = "implicit",
                           over_ranks: bool = True) -> torch.Tensor:
    """:func:`moore_penrose_pinv` by its plain version on any device, for a
    caller that asks for the plain path by name (``use_pallas=False``), as
    the JAX package's dense branch does (``models/nystrom.py:258-261``
    there): ``implicit`` the same gradient as :class:`PinvImplicit`,
    ``exact`` autograd through the iterations and the global scale."""
    if grad == "implicit":
        return PinvImplicitRef.apply(x, iters, over_ranks)
    if grad != "exact":
        raise ValueError(f"pinv grad must be 'exact' or 'implicit', got {grad!r}")
    return pinv_iterations_ref(x, global_scale(x, over_ranks), iters)
