"""The inner gradient of second-order MAML, with a pluggable Hessian
transpose.

The meta-gradient through K inner SGD steps needs, at every step, the
transpose of d(inner gradient)/d(params) applied to the incoming cotangent.
The Hessian of a scalar loss is symmetric, so that is a Hessian-vector
product H·ct, and `make_so_grad` computes it one of four ways (`so_impl`):

  "xla"   no custom op: the gradient on the plain route with
          create_graph=True, and autograd's double backward through it;
  "hvp"   H·ct = torch.func.jvp(torch.func.grad(plain loss))(p; ct);
  "rof"   H·ct = torch.func.grad(p -> jvp(plain loss)(p; ct));
  "fhvp"  H·ct = torch.func.jvp of train/so_fused.py's gradient, whose
          LSTM stack runs the second-order kernels (rows 10-11).

For "hvp", "rof" and "fhvp" the gradient is a `torch.autograd.Function`
over the parameter tensors: its forward is the first-order gradient on the
model's own route (the training kernels, rows 4-7, on a card) with no graph,
and keeps only the step's parameters and dropout masks; its backward
recomputes what it needs and returns H·ct. All four give the same
meta-gradient.

Counterpart of `weatherforecast_stgcn_maml_tpu/train/so_grad.py`.
"""

from __future__ import annotations

import torch

SO_IMPLS = ("xla", "hvp", "rof", "fhvp")


def _grads(loss, params: dict, **kwargs) -> dict:
    """d loss / d params ({name: tensor}); zero for a parameter the loss
    does not reach (the encoder under `model.stop_base_gradients`)."""
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True, **kwargs)
    return {k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(params.items(), grads)}


class _InnerGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hvp, loss_fast, aux, masks, names, *values):
        with torch.enable_grad():
            q = {k: v.detach().requires_grad_(True) for k, v in zip(names, values)}
            grads = _grads(loss_fast(q, aux, masks), q)
        ctx.hvp, ctx.aux, ctx.masks, ctx.names = hvp, aux, masks, names
        ctx.save_for_backward(*values)
        return tuple(grads[k] for k in names)

    @staticmethod
    def backward(ctx, *ct):
        q = {k: v.detach() for k, v in zip(ctx.names, ctx.saved_tensors)}
        hv = ctx.hvp(q, dict(zip(ctx.names, ct)), ctx.aux, ctx.masks)
        return (None, None, None, None, None, *(hv[k] for k in ctx.names))


def make_so_grad(loss_fast, loss_diff2, impl: str, fused_grad_fn=None):
    """Build g(p, aux, masks) -> {name: gradient of the support loss at p}.

    loss_fast:     loss(p, aux, masks) on the model's own route (the
                   training kernels), differentiated once for g. For
                   impl="xla" it must be twice differentiable (the plain
                   route).
    loss_diff2:    the same loss on the plain route, differentiated twice
                   inside the Hessian transpose of "hvp" and "rof".
    fused_grad_fn: for "fhvp", so_fused.make_grad_loss_fused's gradient.

    `masks` are the step's dropout masks, drawn once by the caller and used
    for g and for its Hessian alike.
    """
    if impl not in SO_IMPLS:
        raise ValueError(f"meta.so_impl={impl!r}: expected one of {SO_IMPLS}")
    if impl == "xla":
        return lambda p, aux, masks: _grads(loss_fast(p, aux, masks), p, create_graph=True)
    if impl == "fhvp" and fused_grad_fn is None:
        raise ValueError("so_impl='fhvp' requires fused_grad_fn")

    def hvp(q, ct, aux, masks):
        if impl == "fhvp":
            return torch.func.jvp(lambda p: fused_grad_fn(p, aux, masks), (q,), (ct,))[1]
        if impl == "hvp":
            grad = torch.func.grad(loss_diff2)
            return torch.func.jvp(lambda p: grad(p, aux, masks), (q,), (ct,))[1]
        return torch.func.grad(  # "rof"
            lambda p: torch.func.jvp(lambda pp: loss_diff2(pp, aux, masks), (p,), (ct,))[1]
        )(q)

    def g_op(p, aux, masks):
        names = tuple(p)
        out = _InnerGrad.apply(hvp, loss_fast, aux, masks, names, *p.values())
        return dict(zip(names, out))

    return g_op
