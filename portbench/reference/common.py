"""What the references share: the init, the device augmentation, the
loss, the optimizers and the recipe's rates, reduced precision for the
control, the model's own draws, and the training steps that the check
follows.

Plain PyTorch in float32 with TF32 off. Nothing here imports the program:
where the program's arithmetic is part of what a step computes (the
LeCun-normal init drawn from the seed, the augmentation's draws from the
device generator seeded by the step, the model's own draws from the
generator seeded by the step with bit 63 set, the scheduled rate at the
window's epoch, the recipe's rate multipliers by parameter-name prefix),
this file keeps a frozen copy of the rule, written from the recipe's
definition, and computes every step of it in float32 where the program
rounds to bfloat16.

A reference module gives ``build(run_cfg)`` and ``loss_and_backward(model,
imgs, labels, precision, generator=None, per_rank=None)``; it may declare
its recipe's parameter groups (``LR_MULT``, ``LR_MULT_DEFAULT``; see
``rate_multipliers``).

Augmentation (the recipes' train preset): RandomResizedCrop (scale 0.08-1,
ratio 3/4-4/3, boxes clamped), horizontal flip 0.5, TrivialAugmentWide
(one of 14 ops per image, the equalisation over a 64-knot CDF), ImageNet
normalisation, random erasing (p 0.1), in the draw order of the program's
``sample_train_draws``.
"""

from __future__ import annotations

import math
from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# std of a unit normal truncated to [-2, 2]
TRUNC_STD = 0.87962566103423978
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
LABEL_SMOOTHING = 0.1


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class BatchNorm(nn.Module):
    """Train-mode batch normalisation with the batch's biased variance."""

    def __init__(self, c, eps=1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        mean = x.mean(dim=(0, 2, 3), keepdim=True)
        var = ((x - mean) ** 2).mean(dim=(0, 2, 3), keepdim=True)
        scale = self.weight.view(1, -1, 1, 1) * torch.rsqrt(var + self.eps)
        return (x - mean) * scale + self.bias.view(1, -1, 1, 1)


@torch.no_grad()
def lecun_init(model, generator):
    """Conv and linear weights LeCun-normal truncated at two standard
    deviations, in ``model.modules()`` order from ``generator``; biases 0,
    BatchNorm scale 1 and shift 0."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            std = math.sqrt(1.0 / m.weight[0].numel()) / TRUNC_STD
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    return model


# ---------------------------------------------------------------------------
# reduced precision for the control: the trunk's bfloat16 one step down to
# float8, the head's float32 one step down to bfloat16
# ---------------------------------------------------------------------------
def _cast8(x, dtype):
    top = torch.finfo(dtype).max
    scale = top / x.detach().abs().amax().clamp_min(1e-30)
    return ((x * scale).to(dtype).to(x.dtype)) / scale


class _Fp8(torch.autograd.Function):
    """Values rounded to e4m3, their gradients to e5m2 (the usual float8
    training split), each tensor scaled by its largest value."""

    @staticmethod
    def forward(ctx, x):
        return _cast8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _cast8(g, torch.float8_e5m2)


class _Bf16(torch.autograd.Function):
    """Values and their gradients rounded to bfloat16."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def lowp(x, precision):
    """A trunk tensor (an operand of a product, or an activation, which the
    program keeps in bfloat16) in ``precision``."""
    if precision == "float32":
        return x
    if precision == "fp8":
        return _Fp8.apply(x)
    raise ValueError(f"unknown precision {precision!r}")


def head(x, precision):
    """A head tensor (float32 in the program) in ``precision``'s head
    precision."""
    return x if precision == "float32" else _Bf16.apply(x)


def conv(x, m, precision, **kw):
    """A trunk conv: operands and output in the trunk's precision."""
    return lowp(F.conv2d(lowp(x, precision), lowp(m.weight, precision), m.bias,
                         m.stride, m.padding, **kw), precision)


def linear(x, m, precision):
    """A head linear layer: operands in the head's precision."""
    return F.linear(head(x, precision), head(m.weight, precision), m.bias)


def cross_entropy_sum(logits, labels):
    """Label-smoothed (0.1) softmax cross entropy, summed over rows."""
    c = logits.shape[-1]
    target = F.one_hot(labels.long(), c).to(logits.dtype)
    target = target * (1.0 - LABEL_SMOOTHING) + LABEL_SMOOTHING / c
    return -(target * F.log_softmax(logits, dim=-1)).sum()


# ---------------------------------------------------------------------------
# the device augmentation, in float32
# ---------------------------------------------------------------------------
def _uniform(gen, b, lo=0.0, hi=1.0):
    return torch.rand((b,), generator=gen, device=gen.device) * (hi - lo) + lo


def train_draws(gen, b, h, w, erase_prob=0.1):
    """Every draw of one augmented batch, in the program's order."""
    area = _uniform(gen, b, 0.08, 1.0)
    log_ratio = _uniform(gen, b, math.log(3 / 4), math.log(4 / 3))
    u_y, u_x = _uniform(gen, b), _uniform(gen, b)
    target = float(h * w) * area
    aspect = torch.exp(log_ratio)
    cw = torch.sqrt(target * aspect).clamp(8.0, float(w))
    ch = torch.sqrt(target / aspect).clamp(8.0, float(h))
    draws = {"boxes": torch.stack([u_y * (h - ch), u_x * (w - cw), ch, cw], 1)}
    draws["flip"] = _uniform(gen, b) < 0.5
    op = torch.randint(0, 14, (b,), generator=gen, device=gen.device)
    u = torch.rand((b,), generator=gen, device=gen.device)
    sign = torch.rand((b,), generator=gen, device=gen.device) < 0.5
    draws["ta_op"], draws["ta_mag"] = op, torch.where(sign, u, -u)
    on = _uniform(gen, b) < erase_prob
    draws["erase"] = (on, _uniform(gen, b, 0.02, 0.33),
                      _uniform(gen, b, math.log(0.3), math.log(3.3)),
                      _uniform(gen, b), _uniform(gen, b))
    return draws


def _rcp(n):
    return float(np.float32(1.0) / np.float32(n))


def _interp_weights(starts, sizes, in_size, out_size):
    """[B, out, in] bilinear weights (half-pixel centres) of the windows
    [start, start + size), samples clamped to the window, rows summing to 1."""
    starts = starts.float()[:, None]
    sizes = sizes.float()[:, None]
    j = torch.arange(out_size, dtype=torch.float32, device=starts.device)[None, :]
    src = torch.addcmul(starts, j + 0.5, sizes * _rcp(out_size)) - 0.5
    lo = starts.clamp(0.0, float(in_size - 1))
    hi = (starts + sizes - 1.0).clamp(0.0, float(in_size - 1))
    src = torch.minimum(torch.maximum(src, lo), hi)
    i0 = torch.floor(src)
    frac = src - i0
    i = torch.arange(in_size, dtype=torch.float32, device=starts.device)[None, None, :]
    w0 = (1.0 - (i - i0[..., None]).abs()).clamp(0.0, 1.0) * (1.0 - frac[..., None])
    w1 = (1.0 - (i - (i0[..., None] + 1.0)).abs()).clamp(0.0, 1.0) * frac[..., None]
    w = w0 + w1
    return w / w.sum(-1, keepdim=True).clamp_min(1e-6)


def crop_resize(imgs, boxes, size, flip):
    """Per-image box crop resized to ``size`` (NHWC float32), the flip
    folded into the column weights."""
    b, h, w, c = imgs.shape
    wy = _interp_weights(boxes[:, 0], boxes[:, 2], h, size)
    wx = _interp_weights(boxes[:, 1], boxes[:, 3], w, size)
    wx = torch.where(flip[:, None, None], wx.flip(1), wx)
    rows = torch.einsum("boh,bhwc->bowc", wy, imgs)
    return torch.einsum("bpw,bowc->bopc", wx, rows).contiguous()


def _grid_sample(images, ys, xs):
    """Bilinear samples at pixel coordinates, zero outside the image."""
    b, h, w, c = images.shape
    y = ys.reshape(b, -1)
    x = xs.reshape(b, -1)
    y0, x0 = torch.floor(y), torch.floor(x)
    wy1, wx1 = (y - y0)[..., None], (x - x0)[..., None]
    padded = F.pad(images, (0, 0, 1, 1, 1, 1)).reshape(b, (h + 2) * (w + 2), c)
    iy = (y0 + 1).clamp(0, h).long()
    ix = (x0 + 1).clamp(0, w).long()

    def tap(dy, dx):
        flat = ((iy + dy) * (w + 2) + ix + dx)[..., None].expand(-1, -1, c)
        return torch.gather(padded, 1, flat)

    ok = ((y0 >= -1) & (y0 <= h - 1) & (x0 >= -1) & (x0 <= w - 1)).float()[..., None]
    top = tap(0, 0) * (1 - wx1) + tap(0, 1) * wx1
    bot = tap(1, 0) * (1 - wx1) + tap(1, 1) * wx1
    return ((top * (1 - wy1) + bot * wy1) * ok).reshape(images.shape)


def _affine(op, mag, h, w, x):
    """Shear x/y (0.99), translate x/y (32 px), rotate (135 deg about the
    centre): the output -> input map of PIL's AFFINE, zero fill."""
    zero = torch.zeros_like(mag)
    is_sx, is_sy, is_tx, is_ty, is_rot = (op == k for k in (1, 2, 3, 4, 5))
    theta = mag * 135.0 * math.pi / 180.0
    cos_t = torch.where(is_rot, torch.cos(theta), zero + 1.0)
    sin_t = torch.where(is_rot, torch.sin(theta), zero)
    a = cos_t
    bb = torch.where(is_sx, mag * 0.99, zero) + torch.where(is_rot, sin_t, zero)
    d = torch.where(is_sy, mag * 0.99, zero) - torch.where(is_rot, sin_t, zero)
    c = torch.where(is_tx, mag * 32.0, zero)
    f = torch.where(is_ty, mag * 32.0, zero)
    oy = torch.where(is_rot, zero + (h - 1) / 2.0, zero)[:, None, None]
    ox = torch.where(is_rot, zero + (w - 1) / 2.0, zero)[:, None, None]
    ys = torch.arange(h, dtype=torch.float32, device=x.device)[None, :, None] - oy
    xs = torch.arange(w, dtype=torch.float32, device=x.device)[None, None, :] - ox
    v = lambda t: t[:, None, None]  # noqa: E731
    src_x = v(a) * xs + v(bb) * ys + v(c) + ox
    src_y = v(d) * xs + v(cos_t) * ys + v(f) + oy
    src_y, src_x = torch.broadcast_tensors(src_y, src_x)
    return _grid_sample(x, src_y, src_x)


def _equalize(x, knots=64):
    """Each pixel through its image channel's CDF at 64 knots, linearly
    interpolated."""
    b, h, w, c = x.shape
    levels = torch.arange(knots, dtype=torch.float32, device=x.device) * (1.0 / (knots - 1))
    levels[-1] = 1.0
    # share of each image channel at or below each knot: a histogram of the
    # first knot at or above each pixel, cumulated
    first = torch.searchsorted(levels, x.permute(0, 3, 1, 2).reshape(b * c, -1).contiguous())
    counts = torch.zeros(b * c, knots + 1, dtype=torch.float32, device=x.device)
    counts.scatter_add_(1, first, torch.ones_like(first, dtype=torch.float32))
    cdf = (counts[:, :knots].cumsum(-1) / float(h * w)).view(b, c, knots)
    pos = x.clamp(0.0, 1.0) * (knots - 1)
    i0 = torch.floor(pos)
    frac = pos - i0
    i0 = i0.long()
    i1 = (i0 + 1).clamp_max(knots - 1)
    table = cdf.permute(0, 2, 1)  # [B, K, C]
    pick = lambda i: torch.gather(  # noqa: E731
        table, 1, i.reshape(b, -1, c)).reshape(b, h, w, c)
    return pick(i0) * (1 - frac) + pick(i1) * frac


def trivial_augment_wide(x, op, mag):
    b, h, w, _ = x.shape
    sel = lambda k: (op == k)[:, None, None, None]  # noqa: E731
    out = torch.where(((op >= 1) & (op <= 5))[:, None, None, None],
                      _affine(op, mag, h, w, x), x)
    s = mag[:, None, None, None]
    m = s.abs()
    gain = 1.0 + s * 0.99
    out = torch.where(sel(6), (out * gain).clamp(0.0, 1.0), out)
    gray = (out * torch.tensor((0.299, 0.587, 0.114), device=x.device)).sum(-1, keepdim=True)
    out = torch.where(sel(7), (gray + gain * (out - gray)).clamp(0, 1), out)
    mean_gray = gray.mean(dim=(1, 2, 3), keepdim=True)
    out = torch.where(sel(8), (mean_gray + gain * (out - mean_gray)).clamp(0, 1), out)
    kern = torch.tensor([1, 1, 1, 1, 5, 1, 1, 1, 1], dtype=torch.float32,
                        device=x.device).view(1, 1, 3, 3) / 13.0
    smooth = F.conv2d(out.permute(0, 3, 1, 2), kern.expand(3, 1, 3, 3),
                      padding=1, groups=3).permute(0, 2, 3, 1)
    out = torch.where(sel(9), (smooth + gain * (out - smooth)).clamp(0, 1), out)
    shift = 2.0 ** (8.0 - torch.round(8.0 - m * 6.0))
    out = torch.where(sel(10), torch.floor(torch.floor(out * 255.0) / shift)
                      * shift / 255.0, out)
    out = torch.where(sel(11), torch.where(out >= 1.0 - m, 1.0 - out, out), out)
    lo = out.amin(dim=(1, 2), keepdim=True)
    hi = out.amax(dim=(1, 2), keepdim=True)
    out = torch.where(sel(12), (out - lo) / (hi - lo).clamp_min(1e-6), out)
    return torch.where(sel(13), _equalize(out), out)


def random_erase(x, on, area, log_ratio, u_y, u_x):
    b, h, w, _ = x.shape
    target = float(h * w) * area
    eh = torch.sqrt(target * torch.exp(log_ratio)).clamp(1.0, float(h - 1))
    ew = torch.sqrt(target / torch.exp(log_ratio)).clamp(1.0, float(w - 1))
    y0, x0 = u_y * (h - eh), u_x * (w - ew)
    ys = torch.arange(h, dtype=torch.float32, device=x.device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=x.device)[None, None, :]
    inside = ((ys >= y0[:, None, None]) & (ys < (y0 + eh)[:, None, None])
              & (xs >= x0[:, None, None]) & (xs < (x0 + ew)[:, None, None]))
    return torch.where((inside & on[:, None, None])[..., None], 0.0, x)


def augment(batch_u8, draws, size):
    """uint8 [B, R, R, 3] -> float32 [B, size, size, 3]."""
    x = crop_resize(batch_u8.float() / 255.0, draws["boxes"], size, draws["flip"])
    x = trivial_augment_wide(x, draws["ta_op"], draws["ta_mag"])
    mean = torch.tensor(IMAGENET_MEAN, device=x.device)
    std = torch.tensor(IMAGENET_STD, device=x.device)
    return random_erase((x - mean) / std, *draws["erase"])


def augmented_batch(pool_images, pool_labels, rows, seed, step, size,
                    per_rank, device):
    """The global batch of ``rows`` as the ranks see it: each rank's slice of
    ``per_rank`` rows augmented with the draws of the generator that the
    program seeds with ``seed * 2**32 + step`` on every rank."""
    imgs, labels = [], []
    gen = torch.Generator(device=device)
    for r0 in range(0, len(rows), per_rank):
        part = rows[r0:r0 + per_rank]
        u8 = torch.from_numpy(pool_images[part]).to(device)
        gen.manual_seed(seed * 2**32 + step)
        draws = train_draws(gen, len(part), u8.shape[1], u8.shape[2])
        imgs.append(augment(u8, draws, size))
        labels.append(torch.from_numpy(pool_labels[part]).to(device))
    return torch.cat(imgs), torch.cat(labels)


# ---------------------------------------------------------------------------
# the model's own draws (dropout masks, sampled offsets)
# ---------------------------------------------------------------------------
def model_generator(seed, step, device):
    """The generator of the model's own draws at ``step``: seeded
    ``(seed * 2**32 + step) | 1 << 63`` on every rank, the augmentation's
    seed with bit 63 set (from a seed of 2**31 up, that bit is set already,
    and the two streams are one)."""
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 2**32 + step) | 1 << 63)
    return gen


def rank_generators(generator, rows, per_rank):
    """One generator for each rank's slice of ``rows`` global rows, each
    seeded as ``generator`` was, as each rank's program seeds its own: a
    module draws slice ``i``'s draws from the ``i``-th, in the order its
    program draws them."""
    gens = []
    for _ in range(0, rows, per_rank):
        gen = torch.Generator(device=generator.device)
        gen.manual_seed(generator.initial_seed())
        gens.append(gen)
    return gens


# ---------------------------------------------------------------------------
# the recipe's rates: the scheduled rate and the groups' multipliers
# ---------------------------------------------------------------------------
def epoch_rate(run_cfg, epoch=0):
    """The rate at ``epoch`` (every phase of a run is at epoch 0) of the
    configuration's ``train.scheduler`` from ``train.optimizer.lr``, as the
    recipes define their schedulers:

    * none, or a name of none and no ``T_max``: constant;
    * ``CosineAnnealingLR``, or a name of none with a ``T_max`` (recipes
      that build warm-up and cosine in their Example): torch's ``LinearLR``
      from ``lr_warmup_decay`` (0.01) x the rate up to it over
      ``warmup_epochs`` (0), then the cosine from the rate down to
      ``eta_min`` (0) over ``T_max`` (30) less the warm-up;
    * ``StepLR``: x ``gamma`` (0.1) every ``step_size`` epochs;
    * ``MultiStepLR``: x ``gamma`` (0.1) at each of ``milestones``;
    * ``ReduceLROnPlateau``: the rate; only a validation metric lowers it,
      and a run validates nothing."""
    lr = float(run_cfg["train"]["optimizer"]["lr"])
    sched = run_cfg["train"].get("scheduler") or {}
    name = sched.get("name")
    if name in (None, "", "None", "none", "Constant"):
        if "T_max" not in sched:
            return lr
        name = "WarmupCosine"
    if name in ("CosineAnnealingLR", "WarmupCosine"):
        warmup = int(sched.get("warmup_epochs", 0))
        if warmup and epoch < warmup:
            start = float(sched.get("lr_warmup_decay", 0.01))
            return lr * (start + (1.0 - start) * (epoch / warmup))
        t_max = int(sched.get("T_max", 30))
        eta_min = float(sched.get("eta_min", 0.0))
        e = min(epoch - warmup, t_max)
        return eta_min + 0.5 * (lr - eta_min) * (
            1 + math.cos(math.pi * e / max(t_max - warmup, 1)))
    gamma = float(sched.get("gamma", 0.1))
    if name == "StepLR":
        return lr * gamma ** (epoch // int(sched["step_size"]))
    if name == "MultiStepLR":
        return lr * gamma ** sum(1 for m in sched["milestones"] if epoch >= int(m))
    if name == "ReduceLROnPlateau":
        return lr
    raise ValueError(f"unknown scheduler {name!r}")


def rate_multipliers(ref, names):
    """{leaf: rate multiplier} by the reference module's recipe groups.

    ``LR_MULT`` ({dot-joined name prefix: multiplier}, the recipe's values)
    names the groups: a prefix matches the leaf of that name and those
    under it (``backbone`` matches ``backbone.x``, not ``backbone2.x``), and
    the first rule that matches wins; a leaf that none matches gets
    ``LR_MULT_DEFAULT`` (1.0). A module that declares no groups steps every
    leaf at 1.0."""
    rules = getattr(ref, "LR_MULT", {})
    default = float(getattr(ref, "LR_MULT_DEFAULT", 1.0))
    return {n: float(next((m for prefix, m in rules.items()
                           if n == prefix or n.startswith(prefix + ".")), default))
            for n in names}


# ---------------------------------------------------------------------------
# optimizers: SGD with momentum and Adam, both with coupled L2
# ---------------------------------------------------------------------------
class Optimizer:
    """Each leaf steps at ``lr`` times its multiplier in ``mult``."""

    def __init__(self, params, cfg, lr, mult):
        self.params = params
        self.name = str(cfg["name"]).lower()
        self.lr = float(lr)
        self.mult = mult
        self.wd = float(cfg.get("weight_decay", 0.0))
        self.momentum = float(cfg.get("momentum", 0.0))
        self.betas = (float(cfg.get("beta1", 0.9)), float(cfg.get("beta2", 0.999)))
        self.eps = float(cfg.get("eps", 1e-8))
        self.state = {}
        self.t = 0

    @torch.no_grad()
    def step(self):
        self.t += 1
        b1, b2 = self.betas
        for name, p in self.params.items():
            lr = self.lr * self.mult[name]
            g = p.grad + self.wd * p
            st = self.state.setdefault(name, {})
            if self.name == "sgd":
                buf = st.get("buf")
                buf = g.clone() if buf is None else buf.mul_(self.momentum).add_(g)
                st["buf"] = buf
                p.sub_(lr * buf)
            elif self.name == "adam":
                m = st.setdefault("m", torch.zeros_like(p)).mul_(b1).add_(g, alpha=1 - b1)
                v = st.setdefault("v", torch.zeros_like(p)).mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v / (1 - b2 ** self.t)).sqrt_().add_(self.eps)
                p.sub_(lr / (1 - b1 ** self.t) * m / denom)
            else:
                raise ValueError(f"unknown optimizer {self.name!r}")


# ---------------------------------------------------------------------------
# the steps that the check follows
# ---------------------------------------------------------------------------
def leaf_norms(tensors):
    return {k: float(torch.linalg.vector_norm(t.double())) for k, t in tensors.items()}


def reference_steps(ref, run_cfg, pool_images, pool_labels, batches, seed,
                    per_rank, device, precision="float32", keep_rows=None):
    """Train the reference from its own init through ``batches`` (global
    index batches, one a step) as the recipe trains, at its scheduled rate
    at epoch 0 times each leaf's group multiplier, with the model's own
    draws from the step's generator, and read what the check compares: each
    step's loss, the per-leaf norm of the first step's gradient, and of the
    parameters' change after the last step; also the rate and the number of
    leaves at each multiplier.

    ``keep_rows``: train on the first ``keep_rows`` rows of each global batch
    only, the mean over them (a fault, or one rank without its exchange)."""
    no_tf32()
    gen = torch.Generator()
    gen.manual_seed(seed)
    model = lecun_init(ref.build(run_cfg), gen).to(device)
    params = dict(model.named_parameters())
    p0 = {k: p.detach().clone() for k, p in params.items()}
    rate = epoch_rate(run_cfg, 0)
    mult = rate_multipliers(ref, params)
    opt = Optimizer(params, run_cfg["train"]["optimizer"], rate, mult)
    size = int(run_cfg["dataset"]["transformer"]["image_size"])
    losses, first = [], None
    for step, rows in enumerate(batches):
        imgs, labels = augmented_batch(pool_images, pool_labels, np.asarray(rows),
                                       seed, step, size, per_rank, device)
        if keep_rows is not None:
            imgs, labels = imgs[:keep_rows], labels[:keep_rows]
        for p in params.values():
            p.grad = torch.zeros_like(p)
        losses.append(ref.loss_and_backward(
            model, imgs, labels, precision,
            generator=model_generator(seed, step, device), per_rank=per_rank))
        if first is None:
            first = leaf_norms({k: p.grad for k, p in params.items()})
        opt.step()
    change = leaf_norms({k: p.detach() - p0[k] for k, p in params.items()})
    del model, params, p0, opt
    return {"losses": losses, "grad_norms": first, "change_norms": change,
            "rate": rate, "leaves_at": dict(Counter(map(repr, mult.values())))}
