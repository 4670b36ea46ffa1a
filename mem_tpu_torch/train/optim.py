"""The optimizer switch with layer decay, port of mem_tpu/train/optim.py
``create_optimizer`` (:497-679), its scheduled transforms (:113-494) and its
layer-id rules (:36-100).

Every optimizer is a ``torch.optim.Optimizer`` over parameter groups keyed
by (lr scale, decays). Weight decay is split as ``build_wd_mask_tree``
(:86-100) splits the flax tree: no decay for 1-D parameters, ``*bias`` and
``cls_token`` / ``pos_embed``; ``mask_token`` (3-D) and the 2-D
relative-position tables are decayed. The lr scale is BEiT's layer decay
(``build_lr_scale_tree``, :74-83): ``decay ** (L + 1 - i)`` with layer id
i = 0 for the patch embedding and the cls / mask / pos tokens, n + 1 for
block n, and L + 1 for the rest (final norm, heads, necks, a shared rel-pos
table); without layer decay every scale is 1 and the groups are the two of
pretraining. The finetune recipe adds a cosine weight-decay schedule (the
caller passes wd[t]), the rel-pos tables as extra no-decay names, and the
linear probe's frozen backbone (lr scale 0 off the head, always AdamW).
Betas default to (0.9, 0.95) (the reference's override,
optim_factory.py:121); segmentation passes (0.9, 0.999). Each step the
caller writes lr[t] * scale and wd[t] into the groups (:set_schedule) and
clips by global norm with factor clip / (norm + 1e-6) before the update
(:152-155, :clip_grad_global_norm); the reported grad norm is the pre-clip
one (:682-685).

The names (``--opt``), each matching the JAX transform it names:
  adamw            torch.optim.AdamW: decoupled wd (:113-178); with
                   ``moment_dtype=torch.bfloat16`` :class:`AdamWLowPrecision`
                   (moments stored in bf16, every blend in f32)
  adam             torch.optim.Adam: L2 wd folded into the gradient
  sgd, nesterov    torch.optim.SGD, Nesterov momentum, L2 wd (:186-222)
  momentum         torch.optim.SGD, heavy ball
  nadam            torch.optim.NAdam (``scale_by_nadam_torch``, :289-332)
  adadelta         torch.optim.Adadelta(rho 0.9, eps 1e-6)
  rmsprop          torch.optim.RMSprop(alpha 0.9): eps outside the sqrt,
                   momentum over the unscaled step
  radam            :class:`RAdam`, ``optax.scale_by_radam`` (eps outside
                   the bias-corrected sqrt, rectified from rho >= 5)
  rmsproptf        :class:`RMSpropTF`: eps inside the sqrt, accumulator
                   from 1.0, momentum over lr-scaled steps (:624-633)
  adafactor        :class:`Adafactor`, ``optax.scale_by_factored_rms()``
  novograd,        :class:`NovoGrad`, ``optax.scale_by_novograd`` with the
  nvnovograd       constant ``weight_decay`` inside, on every tensor
  lamb             :class:`Lamb`: Adam, the masked scheduled decay, the
                   trust ratio (1 where a norm is 0) (:652-667)
  adamp, sgdp      :class:`AdamP`: the projection of :335-374, decoupled
                   multiplicative decay, wd_ratio 0.01 where it fires
and a ``lookahead_`` prefix (:class:`Lookahead`, k = 6, alpha = 0.5), the
apex ``fused*`` aliases (:541-552) and an explicit ``adahessian`` error.
The JAX optimizers run the wd mask through the gradient (coupled) or the
update (decoupled) exactly where these do; the torch classes' own
arithmetic matches optax's where the JAX package's tests hold them equal.
"""
from __future__ import annotations

import math
import warnings
from typing import Iterable, Optional

import torch
import torch.distributed as dist

BETAS = (0.9, 0.95)
SKIP_NAMES = ("pos_embed", "cls_token")
OPTIMIZERS = ("adamw", "adam", "sgd", "nesterov", "momentum", "nadam", "radam", "adamp",
              "sgdp", "adadelta", "adafactor", "rmsprop", "rmsproptf", "novograd",
              "nvnovograd", "lamb")
ADAMP_DELTA = 0.1        # AdamP's cosine threshold factor (clovaai's delta)
ADAMP_WD_RATIO = 0.01    # its decay factor where the projection fired (optim_factory.py:139-142)
FUSED_ALIASES = {"fusedsgd": "sgd", "fusedmomentum": "momentum", "fusedadam": "adam",
                 "fusedadamw": "adamw", "fusedlamb": "lamb", "fusednovograd": "nvnovograd"}


def decays(name: str, param: torch.Tensor, skip_names=SKIP_NAMES) -> bool:
    """Whether weight decay applies to the parameter ``name`` (a
    state_dict key of the reference schema)."""
    parts = name.split(".")
    if param.ndim <= 1 or parts[-1] == "bias":
        return False
    return not any(p in skip_names for p in parts)


def get_num_layer_for_vit(name: str, num_max_layer: int) -> int:
    """The layer id of the parameter ``name`` (a state_dict key of the
    reference schema, e.g. ``backbone.blocks.3.attn.qkv.weight``), the rules
    of optim.py:36-52 on the port's names. A per-block table is named
    ``relative_position_bias_table`` under its block and takes the block's
    id; only the shared ``rel_pos_bias`` module takes the last one."""
    parts = name.split(".")
    if any(p in ("cls_token", "mask_token", "pos_embed") for p in parts):
        return 0
    if "patch_embed" in parts:
        return 0
    if "rel_pos_bias" in parts:
        return num_max_layer - 1
    for a, b in zip(parts, parts[1:]):
        if a == "blocks" and b.isdigit():
            return int(b) + 1
    return num_max_layer - 1


def layer_decay_values(layer_decay: float, num_layers: int) -> list:
    """scale[i] = decay ** (num_layers + 1 - i) for i in 0..num_layers + 1
    (optim.py:55-59)."""
    n = num_layers + 2
    return [layer_decay ** (n - 1 - i) for i in range(n)]


def lr_scale(name: str, layer_decay: Optional[float], num_layers: int) -> float:
    """``build_lr_scale_tree`` (optim.py:74-83) for one parameter: 1.0 when
    layer decay is off."""
    if layer_decay is None or layer_decay >= 1.0 - 1e-12:
        return 1.0
    values = layer_decay_values(layer_decay, num_layers)
    return values[get_num_layer_for_vit(name, len(values))]


def channel_axes(model: torch.nn.Module) -> dict:
    """{parameter: its output-channel dim}, the axis that AdamP's channel
    view keeps. The JAX package keeps flax's last axis (optim.py:355-359).
    ``from_jax_params`` transposes Linear and Conv kernels, whose flax last
    axis is torch's dim 0 (dim 1 for a transposed conv); every other tensor
    keeps its flax layout, and with it the last axis."""
    out = {}
    for module in model.modules():
        for pname, p in module.named_parameters(recurse=False):
            if pname == "weight" and isinstance(module, torch.nn.Linear):
                out[p] = 0
            elif pname == "weight" and isinstance(module, torch.nn.modules.conv._ConvNd):
                out[p] = 1 if module.transposed else 0
            else:
                out[p] = p.ndim - 1
    return out


def norm(x: torch.Tensor) -> torch.Tensor:
    """||x|| as a 0-d f32 tensor, accurate on either device. On the CPU
    torch's ``vector_norm`` of an f32 tensor is off by ~4e-5 at 2.4 M
    elements and ~3e-4 at 10 M (it accumulates long runs in f32), where its
    ``sum`` (cascade summation) stays at ~1e-7; on CUDA ``vector_norm``'s
    tree reduction is that accurate and reads the tensor once."""
    x = x.float()
    return torch.linalg.vector_norm(x) if x.is_cuda else x.square().sum().sqrt()


# ---------------------------------------------------------------------------
# the whole tensor's statistics from a process's piece of it
# ---------------------------------------------------------------------------

class Cut:
    """How a tensor of the whole ``shape`` is cut across processes: along
    ``dim`` over ``group``, or not at all (``group`` None: one process, a
    replicated tensor, or a group of one). The statistics below are those of
    the whole tensor taken from this process's piece (the JAX package takes
    them over the global array, GSPMD adding the collectives): a reduction
    over the cut dim is summed (or maxed) over the group, any other stays
    local. Uncut, each is the plain reduction."""

    def __init__(self, shape, group=None, dim=None):
        self.shape = tuple(shape)
        self.group = group if group is not None and dist.get_world_size(group) > 1 else None
        self.dim = dim if self.group is not None else None
        self.param = None       # the parameter, where an optimizer's step names it

    def _all_reduce(self, x, op=None):
        x = x.contiguous()
        dist.all_reduce(x, op=op or dist.ReduceOp.SUM, group=self.group)
        return x

    def sum(self, x, dims, keepdim=False):
        """``x`` (laid out as the tensor) summed over ``dims``."""
        s = x.sum(dims, keepdim=keepdim)
        return self._all_reduce(s) if self.dim in dims else s

    def mean(self, x, dims, keepdim=False):
        if self.dim not in dims:
            return x.mean(dims, keepdim=keepdim)
        return self.sum(x, dims, keepdim) / math.prod(self.shape[d] for d in dims)

    def amax(self, x, kept):
        """The largest element of ``x``, a reduction of the tensor that keeps
        its dims ``kept`` (an empty piece counts as -inf)."""
        m = x.amax() if x.numel() else x.new_full((), float("-inf"))
        return self._all_reduce(m, dist.ReduceOp.MAX) if self.dim in kept else m

    def norm(self, x):
        """||x|| over the whole tensor, a 0-d f32 tensor (:func:`norm`)."""
        if self.group is None:
            return norm(x)
        return self._all_reduce(x.float().square().sum()).sqrt()

    def drop(self, d):
        """The cut of a tensor indexed as this one without its dim ``d``
        (Adafactor's factored moments): whole when ``d`` is the cut dim."""
        shape = self.shape[:d] + self.shape[d + 1:]
        if self.dim is None or self.dim == d:
            return Cut(shape)
        return Cut(shape, self.group, self.dim - (self.dim > d))


def split(t, cuts=None):
    """(this process's piece of ``t``, its :class:`Cut`): an FSDP2 DTensor is
    cut along its ``Shard`` placement over its mesh's group, a tensor that
    ``cuts`` maps to (group, dim) (tensor parallelism,
    ``Placement.sharded()``) along that dim, anything else is whole. Under
    ``no_grad`` a DTensor's piece is its local tensor: in-place updates of
    the piece update the DTensor."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        group = dim = None
        for i, pl in enumerate(t.placements):
            if pl.is_shard():
                group, dim = t.device_mesh.get_group(i), pl.dim
        return t.to_local(), Cut(t.shape, group, dim)
    cut = (cuts or {}).get(t)
    if cut is None:
        return t, Cut(t.shape)
    group, dim = cut
    shape = list(t.shape)
    shape[dim] *= dist.get_world_size(group)
    return t, Cut(shape, group, dim)


def dropped_placement(placement, d: int):
    """The DTensor placement of a tensor indexed as one placed by
    ``placement`` without its dim ``d``: Replicate where ``d`` was the
    sharded dim, the shard dim renumbered otherwise."""
    from torch.distributed.tensor import Replicate, Shard

    if not placement.is_shard():
        return placement
    if placement.dim == d:
        return Replicate()
    return Shard(placement.dim - (placement.dim > d))


# ---------------------------------------------------------------------------
# the optimizers the torch package does not have in the JAX package's form
# ---------------------------------------------------------------------------

class AdamWLowPrecision(torch.optim.Optimizer):
    """AdamW whose moments are stored in ``moment_dtype`` (``--bf16_moments
    1``), ``scheduled_adamw(moment_dtype=...)`` (optim.py:113-178): each step
    casts the stored moments up to f32, blends them with the f32 gradient,
    takes the update from the unrounded f32 moments, and rounds once on
    store. The parameters stay f32."""

    def __init__(self, params, lr=1e-3, betas=BETAS, eps=1e-8, weight_decay=0.0,
                 moment_dtype=torch.bfloat16):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay, moment_dtype=moment_dtype))

    def load_state_dict(self, state_dict):
        super().load_state_dict(state_dict)
        for group in self.param_groups:   # torch casts the state to the params' dtype
            for p in group["params"]:
                st = self.state.get(p)
                if st:
                    for k in ("exp_avg", "exp_avg_sq"):
                        st[k] = st[k].to(group["moment_dtype"])

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            ps = [p for p in group["params"] if p.grad is not None]
            if not ps:
                continue
            b1, b2 = group["betas"]
            for p in ps:
                if not self.state[p]:
                    self.state[p] = {
                        "step": torch.zeros((), dtype=torch.float32),
                        "exp_avg": torch.zeros_like(p, dtype=group["moment_dtype"]),
                        "exp_avg_sq": torch.zeros_like(p, dtype=group["moment_dtype"])}
            sts = [self.state[p] for p in ps]
            for st in sts:
                st["step"] += 1
            t = int(sts[0]["step"].item())
            g = [p.grad.float() for p in ps]
            ms = [st["exp_avg"] for st in sts]
            vs = [st["exp_avg_sq"] for st in sts]
            # f32 blends of the stored moments, cast up exactly inside the adds
            mu = torch._foreach_mul(g, 1 - b1)
            torch._foreach_add_(mu, ms, alpha=b1)
            nu = torch._foreach_mul(g, 1 - b2)
            torch._foreach_mul_(nu, g)
            torch._foreach_add_(nu, vs, alpha=b2)
            torch._foreach_copy_(ms, mu)     # one rounding, on store
            torch._foreach_copy_(vs, nu)
            # the step from the unrounded blends: mu / c1 / (sqrt(nu / c2) + eps)
            torch._foreach_div_(nu, 1 - b2 ** t)
            torch._foreach_sqrt_(nu)
            torch._foreach_add_(nu, group["eps"])
            torch._foreach_div_(mu, 1 - b1 ** t)
            torch._foreach_div_(mu, nu)
            if group["weight_decay"]:
                torch._foreach_add_(mu, ps, alpha=group["weight_decay"])
            torch._foreach_add_(ps, mu, alpha=-group["lr"])


class _PerTensor(torch.optim.Optimizer):
    """An optimizer whose update is written per parameter: ``_init(p,
    group)`` returns its fresh state (laid out as ``p``) and ``_update(p, g,
    st, group, t, cut)`` updates ``p`` in place, where ``p``, ``g`` and the
    state are this process's pieces (:func:`split`), ``cut`` says how the
    parameter is cut (:class:`Cut`, with the parameter itself as
    ``cut.param``), ``g`` is the gradient with the group's L2 weight decay
    folded in when ``coupled_wd`` is set and ``t`` is the step count after
    the increment (the optax count + 1). ``cuts`` maps the tensor-parallel
    cuts to (group, dim) (parallel/mesh.py sets it); FSDP2's DTensors carry
    theirs."""

    coupled_wd = True
    cuts: Optional[dict] = None

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st.update(step=torch.zeros((), dtype=torch.float32), **self._init(p, group))
                st["step"] += 1
                lp, cut = split(p, self.cuts)
                cut.param = p
                g = split(p.grad)[0]
                if self.coupled_wd and group["weight_decay"]:
                    g = g + group["weight_decay"] * lp
                local = {k: split(v)[0] if torch.is_tensor(v) else v for k, v in st.items()}
                self._update(lp, g, local, group, int(st["step"].item()), cut)


class RAdam(_PerTensor):
    """``optax.scale_by_radam(threshold=5)`` under L2 weight decay: the
    rectified Adam step where rho_t >= 5, the bias-corrected first moment
    otherwise; eps is added outside sqrt(v / (1 - b2^t)), as optax does
    (torch's RAdam adds it before the bias correction)."""

    def __init__(self, params, lr=1e-3, betas=BETAS, eps=1e-8, weight_decay=0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))

    def _init(self, p, group):
        return {"exp_avg": torch.zeros_like(p), "exp_avg_sq": torch.zeros_like(p)}

    def _update(self, p, g, st, group, t, cut):
        b1, b2 = group["betas"]
        m, v = st["exp_avg"], st["exp_avg_sq"]
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        ro = ro_inf - 2 * t * b2 ** t / (1 - b2 ** t)
        mhat = m / (1 - b1 ** t)
        if ro >= 5.0:
            r = math.sqrt((ro - 4) * (ro - 2) * ro_inf / ((ro_inf - 4) * (ro_inf - 2) * ro))
            mhat = r * mhat / ((v / (1 - b2 ** t)).sqrt() + group["eps"])
        p.add_(mhat, alpha=-group["lr"])


class RMSpropTF(_PerTensor):
    """timm's RMSpropTF as the JAX package builds it (optim.py:624-633):
    ``scale_by_rms(decay 0.9, initial_scale 1.0, eps_in_sqrt)``, then lr,
    then a momentum buffer over the lr-scaled steps (TF1 semantics)."""

    def __init__(self, params, lr=1e-2, eps=1e-8, momentum=0.9, weight_decay=0.0):
        super().__init__(params, dict(lr=lr, eps=eps, momentum=momentum,
                                      weight_decay=weight_decay))

    def _init(self, p, group):
        st = {"square_avg": torch.ones_like(p)}
        if group["momentum"]:
            st["momentum_buffer"] = torch.zeros_like(p)
        return st

    def _update(self, p, g, st, group, t, cut):
        nu = st["square_avg"]
        nu.mul_(0.9).addcmul_(g, g, value=1 - 0.9)
        step = g * torch.rsqrt(nu + group["eps"]) * group["lr"]
        if group["momentum"]:
            step = st["momentum_buffer"].mul_(group["momentum"]).add_(step)
        p.sub_(step)


def _factored_dims(shape):
    """optax's ``_factored_dims`` at its defaults: the (second largest,
    largest) dims when the second largest is >= 128, else None. For equal
    sizes the factored estimate is symmetric in the two dims, so the tie
    order does not change the update."""
    if len(shape) < 2:
        return None
    order = sorted(range(len(shape)), key=lambda i: shape[i])
    if shape[order[-2]] < 128:
        return None
    return order[-2], order[-1]


class Adafactor(_PerTensor):
    """``optax.scale_by_factored_rms()`` at its defaults (decay_rate 0.8
    with t^-0.8 decay, epsilon 1e-30 on g^2, factored second moments for
    tensors with two dims >= 128, no first moment, no update clipping)
    under L2 weight decay, then lr. Not ``torch.optim.Adafactor``, whose
    rule differs."""

    def __init__(self, params, lr=1e-3, weight_decay=0.0):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay))

    def _init(self, p, group):
        lp, cut = split(p, self.cuts)
        dims = _factored_dims(cut.shape)
        if dims is None:
            return {"v": torch.zeros_like(p)}
        d1, d0 = dims
        return {"v_row": factored_zeros(p, lp, d0), "v_col": factored_zeros(p, lp, d1)}

    def _update(self, p, g, st, group, t, cut):
        dr = 1.0 - t ** -0.8
        g2 = g * g + 1e-30
        dims = _factored_dims(cut.shape)
        if dims is None:
            v = st["v"].mul_(dr).add_(g2, alpha=1 - dr)
            upd = g * v.rsqrt()
        else:
            # the means over d0 / d1 cross the cut when it is the dim they
            # reduce; v_row / v_col are cut along the dim that survives
            d1, d0 = dims
            vr = st["v_row"].mul_(dr).add_(cut.mean(g2, (d0,)), alpha=1 - dr)
            vc = st["v_col"].mul_(dr).add_(cut.mean(g2, (d1,)), alpha=1 - dr)
            rd1 = d1 - 1 if d1 > d0 else d1
            row = (vr / cut.drop(d0).mean(vr, (rd1,), keepdim=True)).rsqrt()
            upd = g * row.unsqueeze(d0) * vc.rsqrt().unsqueeze(d1)
        p.add_(upd, alpha=-group["lr"])


FACTORED_KEYS = {"v_row": 1, "v_col": 0}   # Adafactor's state key -> its index in _factored_dims


def factored_dim(key: str, shape) -> Optional[int]:
    """The dim of a parameter of the whole ``shape`` that Adafactor's state
    ``key`` drops (``v_row`` the largest, ``v_col`` the second largest);
    None for every other key or an unfactored shape."""
    dims = _factored_dims(tuple(shape)) if key in FACTORED_KEYS else None
    return None if dims is None else dims[FACTORED_KEYS[key]]


def factored_zeros(p, lp, d: int):
    """Zeros laid out as the parameter ``p`` (this process's piece ``lp``)
    without its dim ``d``: a DTensor placed by :func:`dropped_placement`
    under FSDP2, the local piece otherwise."""
    from torch.distributed.tensor import DTensor

    z = lp.new_zeros(lp.shape[:d] + lp.shape[d + 1:])
    if not isinstance(p, DTensor):
        return z
    shape = torch.Size(p.shape[:d] + p.shape[d + 1:])
    return DTensor.from_local(z, p.device_mesh, [dropped_placement(pl, d) for pl in p.placements],
                              run_check=False, shape=shape, stride=_contiguous_strides(shape))


def _contiguous_strides(shape) -> tuple:
    out, acc = [], 1
    for n in reversed(shape):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))


class NovoGrad(_PerTensor):
    """``optax.scale_by_novograd`` as the JAX package builds it
    (optim.py:634-651): a per-tensor second moment of ||g||^2 (the first
    step sets it), the first moment over g / (sqrt(nu) + eps) plus the
    CONSTANT ``novograd_wd`` * p on every tensor (no mask, no schedule:
    the groups' weight_decay is not read), then lr."""

    coupled_wd = False

    def __init__(self, params, lr=1e-3, betas=BETAS, eps=1e-8, novograd_wd=0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      novograd_wd=novograd_wd, weight_decay=0.0))

    def _init(self, p, group):
        return {"exp_avg": torch.zeros_like(p), "nu": torch.zeros((), dtype=p.dtype,
                                                                   device=p.device)}

    def _update(self, p, g, st, group, t, cut):
        b1, b2 = group["betas"]
        n2 = cut.norm(g) ** 2
        nu = st["nu"]
        nu.copy_(n2 if t == 1 else b2 * nu + (1 - b2) * n2)
        add = g / (nu.sqrt() + group["eps"]) + group["novograd_wd"] * p
        m = st["exp_avg"]
        if t == 1:
            m.copy_(add)
        else:
            m.mul_(b1).add_(add)
        p.add_(m, alpha=-group["lr"])


class Lamb(_PerTensor):
    """LAMB as the JAX package chains it (optim.py:652-667):
    ``scale_by_adam``, then + wd[t] * p under the mask (the group's
    weight_decay), then ``scale_by_trust_ratio()`` (||p|| / ||u||, 1 where
    either norm is 0), then lr."""

    coupled_wd = False

    def __init__(self, params, lr=1e-3, betas=BETAS, eps=1e-8, weight_decay=0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))

    def _init(self, p, group):
        return {"exp_avg": torch.zeros_like(p), "exp_avg_sq": torch.zeros_like(p)}

    def _update(self, p, g, st, group, t, cut):
        b1, b2 = group["betas"]
        m, v = st["exp_avg"], st["exp_avg_sq"]
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        u = (m / (1 - b1 ** t)) / ((v / (1 - b2 ** t)).sqrt() + group["eps"])
        if group["weight_decay"]:
            u = u + group["weight_decay"] * p
        pn, un = cut.norm(p), cut.norm(u)
        zero = (pn == 0) | (un == 0)
        ratio = torch.where(zero, torch.ones_like(pn), pn / torch.where(zero, 1.0, un))
        p.sub_(u * (ratio * group["lr"]))


def adamp_fired(p: torch.Tensor, g: torch.Tensor, axis: int, cut: Optional[Cut] = None) -> tuple:
    """AdamP's decision (optim.py:335-374): (bool tensor "the channel view
    fires", bool tensor "the whole-tensor view fires"), each 0-d. The
    channel view reduces over every dim but ``axis``; it fires where the
    largest |cos(p, g)| over the channels is below 0.1 / sqrt(its size),
    the whole view (only where the channel view did not) below 0.1 /
    sqrt(numel). ``p`` and ``g`` may be a process's pieces of a tensor cut
    as ``cut`` says: the sums and the max are the whole tensor's."""
    cut = cut or Cut(p.shape)
    red = tuple(d for d in range(p.ndim) if d != axis)
    dim_ch = math.prod(cut.shape[d] for d in red)

    def cos(axes):
        num = cut.sum(p * g, axes)
        den = cut.sum(p * p, axes).sqrt() * cut.sum(g * g, axes).sqrt() + 1e-8
        return (num / den).abs()

    use_ch = cut.amax(cos(red), (axis,)) < ADAMP_DELTA / math.sqrt(dim_ch)
    use_all = ~use_ch & (cos(tuple(range(p.ndim))) < ADAMP_DELTA / math.sqrt(math.prod(cut.shape)))
    return use_ch, use_all


class AdamP(_PerTensor):
    """AdamP / SGDP (clovaai, arXiv:2006.08217) as ``scheduled_adamp``
    builds them (optim.py:377-441): Nesterov Adam (or, with
    ``sgd_momentum``, Nesterov SGD) directions; for tensors of 2+ dims the
    radial component is projected out where :func:`adamp_fired` fires,
    over the channel view or the whole tensor; decay is decoupled and
    multiplicative, p *= 1 - lr * wd * ratio with ratio = 0.01 where the
    projection fired and 1 elsewhere. ``axes`` maps each parameter to its
    channel dim (:func:`channel_axes`). The last decision is kept in the
    state as ``fired`` (0-d float: 1 = fired)."""

    coupled_wd = False

    def __init__(self, params, axes: dict, lr=1e-3, betas=BETAS, eps=1e-8,
                 weight_decay=0.0, sgd_momentum=None):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay, sgd_momentum=sgd_momentum))
        self.axes = axes

    def _init(self, p, group):
        st = {"exp_avg": torch.zeros_like(p), "fired": torch.zeros((), device=p.device)}
        if group["sgd_momentum"] is None:
            st["exp_avg_sq"] = torch.zeros_like(p)
        return st

    def _update(self, p, g, st, group, t, cut):
        m = st["exp_avg"]
        if group["sgd_momentum"] is not None:
            mom = group["sgd_momentum"]
            m.mul_(mom).add_(g)
            d = g + mom * m
        else:
            b1, b2 = group["betas"]
            v = st["exp_avg_sq"]
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            c1 = 1 - b1 ** t
            denom = (v / (1 - b2 ** t)).sqrt() + group["eps"]
            d = (b1 * m / c1 + (1 - b1) * g / c1) / denom
        ratio = 1.0
        if p.ndim >= 2:
            axis = self.axes[cut.param]
            use_ch, use_all = adamp_fired(p, g, axis, cut)

            def projected(axes):
                pn = p / (cut.sum(p * p, axes, keepdim=True).sqrt() + 1e-8)
                return d - pn * cut.sum(pn * d, axes, keepdim=True)

            red = tuple(i for i in range(p.ndim) if i != axis)
            d = torch.where(use_ch, projected(red),
                            torch.where(use_all, projected(tuple(range(p.ndim))), d))
            fired = use_ch | use_all
            st["fired"].copy_(fired)
            ratio = torch.where(fired, ADAMP_WD_RATIO, 1.0)
        lr = group["lr"]
        if group["weight_decay"]:
            p.mul_(1 - lr * group["weight_decay"] * ratio)
        p.add_(d, alpha=-lr)


class Lookahead:
    """timm's Lookahead (the ``lookahead_`` prefix, optim.py:462-494) over
    any inner optimizer: every ``k``-th fast step, slow += alpha * (fast -
    slow) and fast = slow. The slow weights start as the parameters at
    construction. The groups are the inner optimizer's (``set_schedule``
    writes into them), and the slow weights and the step count live in
    :meth:`state_dict`, so a resume continues the same trajectory."""

    def __init__(self, inner, k: int = 6, alpha: float = 0.5):
        self.inner, self.k, self.alpha = inner, k, alpha
        self.count = 0
        self.slow = [p.detach().clone() for g in self.param_groups for p in g["params"]]

    # the inner optimizer's, looked up each time: its load_state_dict
    # replaces the group dicts
    @property
    def param_groups(self):
        return self.inner.param_groups

    @property
    def state(self):
        return self.inner.state

    def zero_grad(self, set_to_none: bool = True):
        self.inner.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self, inner_step=None):
        """One fast step (``inner_step``, the inner optimizer's by default:
        ZeRO-1 passes its owned update and broadcast), then the sync."""
        (inner_step or self.inner.step)()
        self.count += 1
        if self.count % self.k == 0:
            fast = [p for g in self.param_groups for p in g["params"]]
            for s, f in zip(self.slow, fast):
                s.add_(f - s, alpha=self.alpha)
                f.copy_(s)

    def state_dict(self):
        return {"inner": self.inner.state_dict(), "lookahead_count": self.count,
                "lookahead_slow": self.slow}

    def load_state_dict(self, state_dict):
        self.inner.load_state_dict(state_dict["inner"])
        self.count = int(state_dict["lookahead_count"])
        for s, v in zip(self.slow, state_dict["lookahead_slow"]):
            s.copy_(v)


# ---------------------------------------------------------------------------
# the factory
# ---------------------------------------------------------------------------

def resolve_name(opt: str) -> tuple:
    """``--opt`` -> (base optimizer name, lookahead?): the last ``_`` part,
    with the apex ``fused*`` names aliased (optim.py:525-552); raises for
    adahessian and for a name the JAX package does not accept."""
    parts = opt.lower().split("_")
    name = FUSED_ALIASES.get(parts[-1], parts[-1])
    if name == "adahessian":
        raise ValueError(
            "adahessian needs Hessian-diagonal estimates (a grad-of-grad pass over the "
            "loss) and cannot be a pure gradient transformation; pick another --opt")
    if name not in OPTIMIZERS:
        raise ValueError(f"unsupported optimizer {opt!r}")
    return name, len(parts) > 1 and parts[0] == "lookahead"


def _groups(model, lr, weight_decay, skip_names, layer_decay, num_layers, freeze_backbone):
    """One group per (lr scale, decays) in the order the parameters first
    meet them, each with its ``lr_scale`` and ``decays``."""
    groups = {(1.0, True): [], (1.0, False): []}
    for name, p in model.named_parameters():
        if p.requires_grad:
            if freeze_backbone:
                key = (1.0 if name.split(".")[0] == "head" else 0.0, decays(name, p))
            else:
                key = (lr_scale(name, layer_decay, num_layers), decays(name, p, skip_names))
            groups.setdefault(key, []).append(p)
    return [{"params": ps, "weight_decay": weight_decay if dec else 0.0, "lr": lr * scale,
             "lr_scale": scale, "decays": dec} for (scale, dec), ps in groups.items()]


def create_optimizer(model: torch.nn.Module, lr: float, weight_decay: float,
                     opt: str = "adamw", opt_eps: float = 1e-8,
                     skip_names=SKIP_NAMES, layer_decay: Optional[float] = None,
                     num_layers: int = 0, betas=BETAS, freeze_backbone: bool = False,
                     momentum: float = 0.9, moment_dtype: Optional[torch.dtype] = None):
    """The ``--opt`` optimizer over the model's trainable parameters (see
    the module docstring for the names), one group per (lr scale, decays):
    without layer decay group 0 decays and group 1 does not. Each group
    carries its ``lr_scale`` and ``decays`` for :func:`set_schedule`.
    ``freeze_backbone`` is the reference's linear probe
    (run_class_finetuning.py:418-436): AdamW whatever ``opt`` says, lr scale
    1 on ``head.*``, 0 on everything else (no layer decay, the default
    decay split), so only the head moves. ``moment_dtype`` stores AdamW's
    moments in that dtype (``--bf16_moments``; AdamW only). Novograd warns
    that it cannot follow the weight-decay schedule the callers write
    through :func:`set_schedule`, as the JAX package warns."""
    name, with_lookahead = resolve_name(opt)
    groups = _groups(model, lr, weight_decay, skip_names, layer_decay, num_layers,
                     freeze_backbone)
    betas = tuple(betas)
    if freeze_backbone:
        return torch.optim.AdamW(groups, lr=lr, betas=betas, eps=opt_eps)
    if name == "adamw" and moment_dtype not in (None, torch.float32):
        inner = AdamWLowPrecision(groups, lr=lr, betas=betas, eps=opt_eps,
                                  moment_dtype=moment_dtype)
    elif name == "adamw":
        inner = torch.optim.AdamW(groups, lr=lr, betas=betas, eps=opt_eps)
    elif name in ("sgd", "nesterov", "momentum"):
        inner = torch.optim.SGD(groups, lr=lr, momentum=momentum,
                                nesterov=name != "momentum" and momentum > 0)
    elif name == "adam":
        inner = torch.optim.Adam(groups, lr=lr, betas=betas, eps=opt_eps)
    elif name == "nadam":
        inner = torch.optim.NAdam(groups, lr=lr, betas=betas, eps=opt_eps,
                                  momentum_decay=4e-3)
    elif name == "radam":
        inner = RAdam(groups, lr=lr, betas=betas, eps=opt_eps)
    elif name == "adamp":
        inner = AdamP(groups, channel_axes(model), lr=lr, betas=betas, eps=opt_eps)
    elif name == "sgdp":
        inner = AdamP(groups, channel_axes(model), lr=lr, sgd_momentum=momentum)
    elif name == "adadelta":
        inner = torch.optim.Adadelta(groups, lr=lr, rho=0.9, eps=1e-6)
    elif name == "adafactor":
        inner = Adafactor(groups, lr=lr)
    elif name == "rmsprop":
        inner = torch.optim.RMSprop(groups, lr=lr, alpha=0.9, eps=opt_eps, momentum=momentum)
    elif name == "rmsproptf":
        inner = RMSpropTF(groups, lr=lr, eps=opt_eps, momentum=momentum)
    elif name in ("novograd", "nvnovograd"):
        warnings.warn(
            "novograd applies weight decay inside the normalized update "
            "(optax.scale_by_novograd); the cosine --weight_decay_end schedule "
            "cannot be threaded there and the CONSTANT --weight_decay is used "
            "instead", stacklevel=2)
        inner = NovoGrad(groups, lr=lr, betas=betas, eps=opt_eps, novograd_wd=weight_decay)
    else:   # lamb
        inner = Lamb(groups, lr=lr, betas=betas, eps=opt_eps)
    return Lookahead(inner, k=6, alpha=0.5) if with_lookahead else inner


def set_schedule(optimizer, lr: float, wd: float) -> None:
    """Write this step's lr * scale into every group and wd into the
    decaying ones."""
    for g in optimizer.param_groups:
        g["lr"] = lr * g["lr_scale"]
        if g["decays"]:
            g["weight_decay"] = wd


def state_bytes(optimizer) -> int:
    """Bytes of every tensor in the optimizer's state (moments, buffers,
    Lookahead's slow weights)."""
    n = sum(v.numel() * v.element_size() for st in optimizer.state.values()
            for v in st.values() if torch.is_tensor(v))
    return n + sum(s.numel() * s.element_size() for s in getattr(optimizer, "slow", []))


def clip_grad_global_norm(params: Iterable[torch.Tensor], clip: Optional[float],
                          sharded: Optional[dict] = None) -> torch.Tensor:
    """The pre-clip global gradient norm (0-d f32 tensor on the grads'
    device); with ``clip > 0`` the grads are scaled in place by
    min(1, clip / (norm + 1e-6)). No host synchronisation.

    The norm is that of the whole gradient on every placement: a gradient
    that is a shard (an FSDP2 DTensor, or a parameter that ``sharded`` maps
    to its tensor-parallel (group, dim); :func:`split`) contributes the sum
    of its shards' squares over the group, and a replicated one counts
    once."""
    grads, norms, shard_sq = [], [], {}
    for p in params:
        if p.grad is None:
            continue
        group = split(p, sharded)[1].group
        g = split(p.grad)[0]
        grads.append(g)
        if group is None:
            norms.append(norm(g))
        else:
            shard_sq.setdefault(group, []).append((len(norms), norm(g) ** 2))
            norms.append(None)
    for group, items in shard_sq.items():
        sq = torch.stack([v for _, v in items])
        dist.all_reduce(sq, group=group)
        for (i, _), v in zip(items, sq.sqrt()):
            norms[i] = v
    total = norm(torch.stack(norms))
    if clip is not None and clip > 0:
        factor = torch.clamp(clip / (total + 1e-6), max=1.0)
        torch._foreach_mul_(grads, factor)
    return total
