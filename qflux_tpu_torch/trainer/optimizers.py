"""The optax optimizers that the JAX package's configs and tests name, as
`torch.optim.Optimizer` subclasses: `optax.adamw`, `optax.adam`,
`optax.lion`, `optax.sgd` and `optax.contrib.prodigy`, each with optax
0.2.6's defaults and every argument a YAML config can give it.  A step
lays its tensors end to end, updates the flat tensors and copies the
results back (a LoRA's hundreds of tensors in a few launches).

Each `step` runs the arithmetic of optax's jitted update in its order and
in f32 (the moments in `mu_dtype` / `accumulator_dtype` where one is set):

  Adam      mu = (1-b1)·g + b1·mu,  nu = (1-b2)·g² + b2·nu,  c = 1 - b^count
            u = mu_hat / (sqrt(nu / c2 + eps_root) + eps), mu_hat = mu / c1
            (nesterov: b1·mu / (1 - b1^(count+1)) + (1-b1)·g / c1)
            adamw: u + weight_decay·p
  Lion      u = sign((1-b1)·g + b1·mu) + weight_decay·p,  mu = (1-b2)·g + b2·mu
  SGD       t = g + momentum·t,  u = t (nesterov: g + momentum·t)
  then      p = p + (-lr)·u

  Prodigy   dlr = estim_lr · lr · sqrt(1 - b2^count) / (1 - b1^count),
            dg = estim_lr · g, and global sums over the whole tree:
            numerator_weighted = b3·nw + (estim_lr / estim_lr0)·dlr·<g, p0 - p>,
            estim_lr = max(estim_lr, coef · nw / Σ|grad_sum|),
            p = p - weight_decay·dlr·p - dlr·exp_avg / (sqrt(exp_avg_sq) + estim_lr·eps)

The learning rate is read from the param group at every step
(`make_train_step` sets it to the schedule's value at the update count,
where optax evaluates its schedule).  A moment kept in bf16 is scaled by
the constant rounded to bf16 (as JAX scales a bf16 array by a weak-typed
Python float), the product kept in f32 (as XLA keeps it in the fused
update).  Divisions divide by a tensor on the moments' device (on
CUDA, a division by a Python scalar is a product with its reciprocal), and
square roots are taken in f64 and rounded to f32 once, the correctly
rounded f32 root that XLA and the CPU compute (torch's CUDA f32 `sqrt` is
not), so the card's update equals the CPU's.

JAX differentiates the LoRA's "scaling" leaves and zeroes their updates
after `optimizer.update`.  For the elementwise optimizers that is the same
as leaving them out, which the Trainer does.  Prodigy's sums run over the
whole tree, so it takes them as `frozen` params: their gradients and state
enter the sums, their updates are dropped.

`optax_layout` names where each piece of state sits in optax's state tree,
which `utils/checkpoint.py` writes into and reads from the JAX trainer's
`optimizer_state.npz`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

# a YAML dtype string (as optax's `canonicalize_dtype` takes it) → torch
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def resolve_dtype(dtype) -> Optional[torch.dtype]:
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if str(dtype) not in DTYPES:
        raise ValueError(f"dtype {dtype!r} is not one of {sorted(DTYPES)}")
    return DTYPES[str(dtype)]


@dataclasses.dataclass(frozen=True)
class OptaxLayout:
    """Where the state sits in optax's state tree, as `_flatten_with_paths`
    keys it: each moment's field name under `prefix` with the torch state
    key and dtype it maps to, the update count's key (None where the state
    has none), the lr schedule's count's key where the lr is a schedule,
    and the tree-wide scalars {field: tensor}."""
    prefix: str
    moments: tuple  # ((optax field, torch state key, dtype), ...)
    count_key: Optional[str]
    schedule_key: Optional[str]
    scalars: dict = dataclasses.field(default_factory=dict)


def _in(value: float, dtype: torch.dtype) -> float:
    """The Python float `value` rounded to `dtype`: the constant JAX
    multiplies an array of that dtype by."""
    return float(torch.tensor(value, dtype=torch.float32).to(dtype))


def _f32(value, device) -> torch.Tensor:
    return torch.tensor(np.float32(value), dtype=torch.float32, device=device)


def _bias(decay: float, count: int) -> np.float32:
    """1 - decay^count in f32, optax's bias correction."""
    return np.float32(1) - np.float32(decay) ** np.float32(count)


def _flat(tensors) -> torch.Tensor:
    """The tensors laid end to end (one launch)."""
    return torch.cat([t.reshape(-1) for t in tensors])


def _store(dst: list, flat: torch.Tensor) -> None:
    """Copy `flat` back into the tensors it was laid out from (one
    multi-tensor launch), cast to their dtype."""
    flat = flat.to(dst[0].dtype)
    torch._foreach_copy_(dst, [v.view_as(t) for v, t in
                               zip(flat.split([t.numel() for t in dst]), dst)])


def _sqrt(t):
    """The correctly rounded f32 square root (module docstring)."""
    return t.double().sqrt_().float()


def _scaled(m, decay: float, dtype):
    """decay·m in f32 for a moment kept in `dtype`: the constant rounded to
    that dtype, the product not (XLA keeps a bf16 product in f32 inside the
    fused update: its `xla_allow_excess_precision`)."""
    return m.float() * (decay if dtype == torch.float32 else _in(decay, dtype))


def _ema(g, m, decay: float, dtype):
    """(1 - decay)·g + decay·m in f32, the first product and the sum as one
    fused multiply-add, as XLA contracts them (in f64, where the product of
    two f32 values is exact, then rounded to f32 once): a moment kept in
    bf16 then rounds as optax's does."""
    rate = float(np.float32(1 - decay))
    return (g.double() * rate + _scaled(m, decay, dtype).double()).float()


def _grads(params):
    return [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]


class _Optax(torch.optim.Optimizer):
    """One param group of f32 tensors; `count` (updates so far) in it.  A
    step lays the params, their gradients and each state of theirs end to
    end (`_flat`), updates the flat tensors, and copies the results back
    (`_store`): a handful of launches for any number of tensors."""

    def __init__(self, params, defaults):
        super().__init__(list(params), {**defaults, "count": 0})
        if len(self.param_groups) != 1:
            raise ValueError(f"{type(self).__name__} takes one parameter group")

    @property
    def count(self) -> int:
        return self.param_groups[0]["count"]

    def set_count(self, count: int) -> None:
        self.param_groups[0]["count"] = int(count)

    def _states(self, params, keys_dtypes) -> list:
        out = []
        for p in params:
            state = self.state[p]
            if not state:
                state.update({k: torch.zeros_like(p, dtype=d) for k, d in keys_dtypes})
            out.append(state)
        return out

    @staticmethod
    def _apply(params, update: torch.Tensor, lr: float) -> None:
        """p + (-lr)·u, optax's `scale_by_learning_rate` and `apply_updates`,
        for the params laid out in `update`'s first elements."""
        _store(params, _flat(params) + update[:sum(p.numel() for p in params)] * -lr)


class Adam(_Optax):
    """`optax.adamw(learning_rate, b1, b2, eps, eps_root, mu_dtype,
    weight_decay, nesterov=...)`, or `optax.adam` with weight_decay None.
    State per tensor: "exp_avg" (mu, in mu_dtype) and "exp_avg_sq" (nu)."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 eps_root: float = 0.0, mu_dtype=None, weight_decay: Optional[float] = 1e-4,
                 nesterov: bool = False):
        super().__init__(params, {"lr": lr, "betas": tuple(betas), "eps": eps,
                                  "eps_root": eps_root, "mu_dtype": resolve_dtype(mu_dtype),
                                  "weight_decay": weight_decay, "nesterov": bool(nesterov)})

    def _mu_dtype(self):
        return self.param_groups[0]["mu_dtype"] or torch.float32

    def optax_layout(self, schedule_count: bool) -> OptaxLayout:
        chained = 2 if self.param_groups[0]["weight_decay"] is not None else 1
        return OptaxLayout("0/", (("mu", "exp_avg", self._mu_dtype()),
                                  ("nu", "exp_avg_sq", torch.float32)),
                           "0/count", f"{chained}/count" if schedule_count else None)

    @torch.no_grad()
    def step(self, closure=None):
        group = self.param_groups[0]
        params = group["params"]
        b1, b2 = group["betas"]
        mu_dtype = self._mu_dtype()
        states = self._states(params, (("exp_avg", mu_dtype), ("exp_avg_sq", torch.float32)))
        mus, nus = [st["exp_avg"] for st in states], [st["exp_avg_sq"] for st in states]
        count = group["count"] + 1
        dev = params[0].device
        g = _flat(_grads(params))
        mu = _ema(g, _flat(mus), b1, mu_dtype)
        nu = _ema(g * g, _flat(nus), b2, torch.float32)
        c1 = _f32(_bias(b1, count), dev)
        if group["nesterov"]:
            mu_hat = mu / _f32(_bias(b1, count + 1), dev) * b1 + g / c1 * (1 - b1)
        else:
            mu_hat = mu / c1
        nu_hat = nu / _f32(_bias(b2, count), dev)
        if group["eps_root"]:
            nu_hat = nu_hat + group["eps_root"]
        update = mu_hat / (_sqrt(nu_hat) + group["eps"])
        if group["weight_decay"] is not None:
            update = update + _flat(params) * group["weight_decay"]
        self._apply(params, update, group["lr"])
        _store(mus, mu)
        _store(nus, nu)
        self.set_count(count)


class Lion(_Optax):
    """`optax.lion(learning_rate, b1, b2, mu_dtype, weight_decay)`.  State
    per tensor: "exp_avg" (mu, in mu_dtype)."""

    def __init__(self, params, lr: float = 1e-4, betas=(0.9, 0.99), mu_dtype=None,
                 weight_decay: float = 1e-3):
        super().__init__(params, {"lr": lr, "betas": tuple(betas),
                                  "mu_dtype": resolve_dtype(mu_dtype),
                                  "weight_decay": weight_decay})

    def _mu_dtype(self):
        return self.param_groups[0]["mu_dtype"] or torch.float32

    def optax_layout(self, schedule_count: bool) -> OptaxLayout:
        return OptaxLayout("0/", (("mu", "exp_avg", self._mu_dtype()),), "0/count",
                           "2/count" if schedule_count else None)

    @torch.no_grad()
    def step(self, closure=None):
        group = self.param_groups[0]
        params = group["params"]
        b1, b2 = group["betas"]
        mu_dtype = self._mu_dtype()
        mus = [st["exp_avg"] for st in self._states(params, (("exp_avg", mu_dtype),))]
        g, m = _flat(_grads(params)), _flat(mus)
        update = torch.sign(_ema(g, m, b1, mu_dtype)) + _flat(params) * group["weight_decay"]
        self._apply(params, update, group["lr"])
        _store(mus, _ema(g, m, b2, mu_dtype))
        self.set_count(group["count"] + 1)


class SGD(_Optax):
    """`optax.sgd(learning_rate, momentum, nesterov, accumulator_dtype)`.
    State per tensor, with momentum: "momentum_buffer" (optax's trace, in
    accumulator_dtype)."""

    def __init__(self, params, lr: float = 1e-3, momentum: Optional[float] = None,
                 nesterov: bool = False, accumulator_dtype=None):
        super().__init__(params, {"lr": lr, "momentum": momentum, "nesterov": bool(nesterov),
                                  "accumulator_dtype": resolve_dtype(accumulator_dtype)})

    def _acc_dtype(self):
        return self.param_groups[0]["accumulator_dtype"] or torch.float32

    def optax_layout(self, schedule_count: bool) -> OptaxLayout:
        moments = ((("trace", "momentum_buffer", self._acc_dtype()),)
                   if self.param_groups[0]["momentum"] is not None else ())
        return OptaxLayout("0/", moments, None, "1/count" if schedule_count else None)

    @torch.no_grad()
    def step(self, closure=None):
        group = self.param_groups[0]
        params = group["params"]
        update = g = _flat(_grads(params))
        decay = group["momentum"]
        if decay is not None:
            dtype = self._acc_dtype()
            traces = [st["momentum_buffer"]
                      for st in self._states(params, (("momentum_buffer", dtype),))]
            trace = g + _scaled(_flat(traces), decay, dtype)
            update = g + trace * decay if group["nesterov"] else trace
            _store(traces, trace)
        self._apply(params, update, group["lr"])
        self.set_count(group["count"] + 1)


class Prodigy(_Optax):
    """`optax.contrib.prodigy(learning_rate, betas, beta3, eps, estim_lr0,
    estim_lr_coef, weight_decay, safeguard_warmup)` over `params` and the
    `frozen` tensors (the LoRA's scaling leaves), whose gradients and state
    take part and whose updates are dropped.  optax's `init` runs here:
    "params0" is every tensor's value now.  State per tensor: "exp_avg",
    "exp_avg_sq", "grad_sum", "params0"; in the group: "estim_lr" and
    "numerator_weighted" (0-dim f32 tensors on the params' device) and
    "count"."""

    KEYS = ("exp_avg", "exp_avg_sq", "grad_sum", "params0")

    def __init__(self, params, lr: float = 1.0, betas=(0.9, 0.999),
                 beta3: Optional[float] = None, eps: float = 1e-8, estim_lr0: float = 1e-6,
                 estim_lr_coef: float = 1.0, weight_decay: float = 0.0,
                 safeguard_warmup: bool = False, frozen=()):
        params, frozen = list(params), list(frozen)
        b1, b2 = betas
        super().__init__(params + frozen, {
            "lr": lr, "betas": (b1, b2), "beta3": b2 ** 0.5 if beta3 is None else beta3,
            "eps": eps, "estim_lr0": estim_lr0, "estim_lr_coef": estim_lr_coef,
            "weight_decay": weight_decay, "safeguard_warmup": bool(safeguard_warmup)})
        self.n_stepped = len(params)
        group = self.param_groups[0]
        dev = group["params"][0].device
        group["estim_lr"] = _f32(estim_lr0, dev)
        group["numerator_weighted"] = _f32(0.0, dev)
        for p in group["params"]:
            self.state[p].update({k: torch.zeros_like(p, dtype=torch.float32)
                                  for k in self.KEYS[:3]})
            self.state[p]["params0"] = p.detach().clone()

    def optax_layout(self, schedule_count: bool) -> OptaxLayout:
        group = self.param_groups[0]
        return OptaxLayout("", tuple((k, k, torch.float32) for k in self.KEYS), "count", None,
                           {"estim_lr": group["estim_lr"],
                            "numerator_weighted": group["numerator_weighted"]})

    @torch.no_grad()
    def step(self, closure=None):
        group = self.param_groups[0]
        params = group["params"]
        b1, b2 = group["betas"]
        b3 = group["beta3"]
        state = {k: [self.state[p][k] for p in params] for k in self.KEYS}
        g = _flat(_grads(params))
        p = _flat(params)
        dev = params[0].device
        count = group["count"] + 1
        estim_lr, lr0 = group["estim_lr"], _f32(group["estim_lr0"], dev)
        bc = np.float32(_bias(b2, count) ** np.float32(0.5)) / _bias(b1, count)
        dlr = estim_lr * group["lr"] * float(bc)
        dg = g * estim_lr
        numerator = (g * (_flat(state["params0"]) - p)).sum()
        exp_avg = _flat(state["exp_avg"]) * b1 + dg * (1 - b1)
        exp_avg_sq = _flat(state["exp_avg_sq"]) * b2 + dg * (1 - b2) * dg
        step_lr = estim_lr if group["safeguard_warmup"] else dlr
        grad_sum = _flat(state["grad_sum"]) * b3 + dg * step_lr / lr0
        weighted = b3 * group["numerator_weighted"] + (estim_lr / lr0) * dlr * numerator
        estim_lr = torch.maximum(estim_lr, group["estim_lr_coef"] * weighted
                                 / grad_sum.abs().sum())
        update = exp_avg * dlr / (_sqrt(exp_avg_sq) + estim_lr * group["eps"])
        if group["weight_decay"]:
            update = update - p * (-group["weight_decay"] * dlr)
        stepped = params[:self.n_stepped]  # the frozen tensors come last
        n = sum(t.numel() for t in stepped)
        _store(stepped, p[:n] - update[:n])
        _store(state["exp_avg"], exp_avg)
        _store(state["exp_avg_sq"], exp_avg_sq)
        _store(state["grad_sum"], grad_sum)
        group["estim_lr"], group["numerator_weighted"] = estim_lr, weighted
        self.set_count(count)


# optimizer.class_path → (class, the arguments a config may give, as the
# optax constructor names them)
OPTIMIZERS = {
    "optax.adamw": (Adam, ("b1", "b2", "eps", "eps_root", "mu_dtype", "weight_decay",
                           "nesterov")),
    "optax.adam": (Adam, ("b1", "b2", "eps", "eps_root", "mu_dtype", "nesterov")),
    "optax.lion": (Lion, ("b1", "b2", "mu_dtype", "weight_decay")),
    "optax.sgd": (SGD, ("momentum", "nesterov", "accumulator_dtype")),
    "optax.contrib.prodigy": (Prodigy, ("betas", "beta3", "eps", "estim_lr0", "estim_lr_coef",
                                        "weight_decay", "safeguard_warmup")),
}


def build(class_path: str, params, lr: float, args: dict, frozen=()) -> torch.optim.Optimizer:
    """The optimizer of `class_path` (a key of OPTIMIZERS) over `params` with
    the config's `args` at optax's defaults where absent; `frozen` (the
    scaling leaves) reaches the optimizers whose update depends on the
    whole tree (Prodigy)."""
    cls, _ = OPTIMIZERS[class_path]
    args = dict(args)
    if cls is Adam or cls is Lion:
        b1, b2 = args.pop("b1", 0.9), args.pop("b2", 0.999 if cls is Adam else 0.99)
        args["betas"] = (b1, b2)
    if class_path == "optax.adam":
        args["weight_decay"] = None
    if cls is Prodigy:
        args["frozen"] = frozen
    return cls(params, lr=lr, **args)
