"""The plain reference of an imagined rollout, in plain PyTorch, and the
comparison that decides ``correct``. It imports nothing of the port, and takes
from the program only the rows that the program wrote into its SAC buffer,
which it judges.

What a rollout is (MBPO's branched rollout; Janner et al., 2019): from B start
states, H steps of a tanh-Gaussian policy action, one step of a probabilistic
ensemble under TS1 propagation (each step a fresh uniform permutation of the
batch gives every elite member an equal contiguous shard), a reparameterised
draw of the next observation's delta and of the reward, the configuration's
termination predicate, and a masked write of the rows still alive, packed in
batch order at the ring's cursor. The randomness is one device generator's, in
this order: the H permutations, then for each step the policy's normals
(B, act) and the model's normals (B, obs + 1).

The judge follows the program step by step from the program's own rows
(teacher forcing): it recomputes each written row's action from the row's
observation and the step's normals, and its next observation and reward from
the row's observation and action, its member and the step's normals, and it
checks exactly that each row's observation continues the previous step's
next observation (the start state at step 0), that its mask is the
predicate's on its next observation, and that the ring's cursor advanced by
the rows written. So no rounding compounds over the steps, and every stage is
checked on its own.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Iterator, Sequence

import torch

TermFn = Callable[[torch.Tensor], torch.Tensor]


@contextlib.contextmanager
def precision(kind: str) -> Iterator[None]:
    """Float32 products in full precision (``"f32"``) or in TF32 (``"tf32"``);
    the caller's settings come back after the block."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = kind == "tf32"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32's 10 mantissa bits, to nearest with ties away from
    zero (what the tensor cores do to a TF32 operand)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, kind: str) -> torch.Tensor:
    """``a @ b`` in float32 (``"f32"``) or TF32 (``"tf32"``: the tensor cores on
    the card, the operands rounded to TF32 elsewhere)."""
    if kind == "tf32" and a.device.type != "cuda":
        a, b = round_tf32(a), round_tf32(b)
    with precision(kind if a.device.type == "cuda" else "f32"):
        return a @ b


@dataclasses.dataclass
class Normalizer:
    mean: torch.Tensor
    std: torch.Tensor


def fit_normalizer(obs: torch.Tensor, act: torch.Tensor, dtype=torch.float64) -> Normalizer:
    """Mean and unbiased std of (obs, act) over the real buffer; a std under
    eps (1e-12 in float64, 1e-5 in float32) counts as 1."""
    data = torch.cat([obs, act], dim=-1).to(dtype)
    mean = data.mean(dim=0, keepdim=True)
    std = data.std(dim=0, keepdim=True, unbiased=True)
    eps = 1e-12 if dtype == torch.float64 else 1e-5
    return Normalizer(mean, torch.where(std < eps, torch.ones_like(std), std))


def normalize(norm: Normalizer, obs: torch.Tensor, act: torch.Tensor) -> torch.Tensor:
    return ((torch.cat([obs, act], dim=-1).to(norm.mean.dtype) - norm.mean) / norm.std).float()


def policy_action(inp, obs: torch.Tensor, eps: torch.Tensor, kind: str = "f32") -> torch.Tensor:
    """The tanh-Gaussian policy's sampled action: two ReLU layers, a mean and
    a log-std head (log-std clipped to [-20, 2]), ``tanh(mean + std * eps)``
    scaled to the action bounds."""
    w, b = inp.policy_w, inp.policy_b
    h = torch.relu(matmul(obs, w[0], kind) + b[0])
    h = torch.relu(matmul(h, w[1], kind) + b[1])
    mean = matmul(h, w[2], kind) + b[2]
    log_std = torch.clamp(matmul(h, w[3], kind) + b[3], -20.0, 2.0)
    scale = (inp.action_high - inp.action_low) / 2.0
    bias = (inp.action_high + inp.action_low) / 2.0
    return torch.tanh(mean + torch.exp(log_std) * eps) * scale + bias


def bounded_logvar(raw: torch.Tensor, max_logvar: torch.Tensor,
                   min_logvar: torch.Tensor) -> torch.Tensor:
    """Soft bounds on a raw log-variance: softplus from above, then below."""
    zero = torch.zeros((), dtype=raw.dtype, device=raw.device)
    lv = max_logvar - torch.logaddexp(max_logvar - raw, zero)
    return min_logvar + torch.logaddexp(lv - min_logvar, zero)


def member_forward(inp, x: torch.Tensor, member: int, kind: str = "f32"):
    """Mean and bounded log-variance of ensemble member ``member`` (an index
    into all members) on rows ``x`` (n, in): SiLU hidden layers, linear head."""
    h = x
    last = len(inp.layer_w) - 1
    for i, (w, b) in enumerate(zip(inp.layer_w, inp.layer_b)):
        h = matmul(h, w[member], kind) + b[member]
        if i < last:
            h = torch.nn.functional.silu(h)
    out = inp.sizes.model_out
    return h[:, :out], bounded_logvar(h[:, out:], inp.max_logvar, inp.min_logvar)


def predict(inp, x: torch.Tensor, members: torch.Tensor, z: torch.Tensor,
            kind: str = "f32") -> torch.Tensor:
    """Each row's draw ``mean + exp(logvar / 2) * z`` from its elite member
    (``members`` indexes ``inp.elite``), member by member."""
    pred = torch.empty((x.shape[0], inp.sizes.model_out), device=x.device)
    elite = inp.elite.tolist()
    for k, m in enumerate(elite):
        rows = (members == k).nonzero().reshape(-1)
        if rows.numel():
            mean, logvar = member_forward(inp, x[rows], m, kind)
            pred[rows] = mean + torch.exp(0.5 * logvar) * z[rows]
    return pred


def draws(gen: torch.Generator, sz, batch: int):
    """The rollout's permutations, then a function giving step t's policy and
    model normals, drawn in the program's order."""
    perms = [torch.randperm(batch, generator=gen, device=gen.device) for _ in range(sz.horizon)]

    def step() -> tuple:
        eps = torch.randn((batch, sz.act), generator=gen, device=gen.device)
        z = torch.randn((batch, sz.model_out), generator=gen, device=gen.device)
        return eps, z

    return perms, step


def members_of(perm: torch.Tensor, elites: int) -> torch.Tensor:
    """TS1's member of each row: slot p of the permuted batch holds row
    perm[p] and is served by elite p // (B / elites)."""
    batch = perm.numel()
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(batch, dtype=perm.dtype, device=perm.device)
    return inv // (batch // elites)


@dataclasses.dataclass
class Ring:
    """A SAC buffer as the judge reads it: ``capacity + 1`` rows of each
    array (the last is where masked rows go) and the cursor and count."""

    obs: torch.Tensor
    act: torch.Tensor
    next_obs: torch.Tensor
    reward: torch.Tensor
    mask: torch.Tensor
    cur_idx: torch.Tensor
    num_stored: torch.Tensor

    @classmethod
    def empty(cls, capacity: int, obs: int, act: int, device) -> "Ring":
        def z(d):
            return torch.zeros((capacity + 1, d), device=device)

        return cls(z(obs), z(act), z(obs), z(1), torch.ones((capacity + 1, 1), device=device),
                   torch.zeros((), dtype=torch.int64, device=device),
                   torch.zeros((), dtype=torch.int64, device=device))

    def write(self, valid: torch.Tensor, rows: Sequence[torch.Tensor]) -> None:
        capacity = self.obs.shape[0] - 1
        offsets = torch.cumsum(valid.long(), 0) - 1
        pos = torch.where(valid, (self.cur_idx + offsets) % capacity,
                          torch.full_like(offsets, capacity))
        for dst, src in zip((self.obs, self.act, self.next_obs, self.reward, self.mask), rows):
            dst[pos] = src.reshape(src.shape[0], -1)
        n = valid.long().sum()
        self.cur_idx.copy_((self.cur_idx + n) % capacity)
        self.num_stored.copy_(torch.clamp(self.num_stored + n, max=capacity))


def rollout(inp, norm: Normalizer, start_obs: torch.Tensor, gen: torch.Generator,
            terminated: TermFn, ring: Ring, kind: str) -> None:
    """The reference's own rollout in products of precision ``kind``, written
    into ``ring``: the control, put in the program's place."""
    sz = inp.sizes
    batch = start_obs.shape[0]
    perms, step = draws(gen, sz, batch)
    obs = start_obs
    alive = torch.ones((batch,), dtype=torch.bool, device=obs.device)
    for t in range(sz.horizon):
        eps, z = step()
        act = policy_action(inp, obs, eps, kind)
        pred = predict(inp, normalize(norm, obs, act), members_of(perms[t], sz.elites), z, kind)
        next_obs = obs + pred[:, :-1]
        term = terminated(next_obs)
        ring.write(alive, (obs, act, next_obs, pred[:, -1], 1.0 - term.float()))
        alive = alive & ~term
        obs = next_obs


def _max(x: torch.Tensor) -> float:
    if x.numel() == 0:
        return 0.0
    return float(torch.nan_to_num(x, nan=float("inf")).max())


def judge(inp, norm: Normalizer, ring, cursor: int, cursor_after: int,
          start_obs: torch.Tensor, gen: torch.Generator, terminated: TermFn) -> Dict[str, float]:
    """The numbers compared for one rollout whose rows begin at ring position
    ``cursor`` and whose writes left the cursor at ``cursor_after``; ``gen``
    is the rollout generator in the state the rollout began from.

    ``rows_wrong``: rows whose observation does not continue the chain, whose
    mask is not the predicate's, plus the rows by which the cursor missed.
    ``action_gap``: the largest gap between a written action and the
    reference's, in units of half the action range. ``model_gap``: the largest
    gap of a written next observation or reward from the reference's, over
    max(1, |reference|)."""
    sz = inp.sizes
    capacity = ring.obs.shape[0] - 1
    batch = start_obs.shape[0]
    dev = start_obs.device
    half = (inp.action_high - inp.action_low) / 2.0
    perms, step = draws(gen, sz, batch)
    alive = torch.arange(batch, device=dev)
    chain = start_obs.clone()
    pos = cursor
    wrong, action_gap, model_gap, rows = 0, 0.0, 0.0, 0
    for t in range(sz.horizon):
        eps, z = step()
        n = alive.numel()
        at = (pos + torch.arange(n, device=dev)) % capacity
        obs, act, next_obs = ring.obs[at], ring.act[at], ring.next_obs[at]
        reward, mask = ring.reward[at, 0], ring.mask[at, 0]
        wrong += int((obs != chain[alive]).any(dim=1).sum())
        action_gap = max(action_gap, _max(
            (act - policy_action(inp, obs, eps[alive])).abs() / half))
        pred = predict(inp, normalize(norm, obs, act), members_of(perms[t], sz.elites)[alive],
                       z[alive])
        ref = torch.cat([obs + pred[:, :-1], pred[:, -1:]], dim=1)
        got = torch.cat([next_obs, reward[:, None]], dim=1)
        model_gap = max(model_gap, _max((got - ref).abs() / ref.abs().clamp(min=1.0)))
        term = terminated(next_obs)
        wrong += int((mask != 1.0 - term.float()).sum())
        chain[alive] = next_obs
        alive = alive[~term]
        pos = (pos + n) % capacity
        rows += n
    miss = (cursor_after - pos) % capacity
    wrong += min(miss, capacity - miss)
    return {"rows_wrong": float(wrong), "action_gap": action_gap, "model_gap": model_gap,
            "rows": float(rows)}
