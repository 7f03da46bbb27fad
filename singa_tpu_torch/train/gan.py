"""Adversarial (GAN) fine-tuning: generator sampling and two discriminators
(counterpart of ``singa_tpu/train/gan.py``; the reference's GAN is a 0-byte
placeholder, SURVEY.md §0).

  * generator: the (CE-pretrained) SINGA model, sampling SMILES token
    sequences from the pocket encoding and the property prefix;
  * sequence discriminator: ``SeqDiscriminator`` over token sequences;
  * graph discriminator: ``GINDiscriminatorDense`` over the molecular graphs
    parsed back from the sampled SMILES on the host, as a BCE or a WGAN-GP
    critic;
  * generator step: REINFORCE with the sequence discriminator's probability,
    the graph discriminator's probability (valid molecules only) and the
    validity-gated chemistry reward, less their batch mean, masked past EOS.

One round samples on the device, scores the samples on the host
(``train/rewards.py``), then runs the discriminator, graph-discriminator and
generator updates on the device from those results. The generator update
recomputes the sampled sequences' log-probs teacher-forced, in parallel
over T: the same value and gradient as the sampler's, since the parameters
have not changed since sampling. The generator step differentiates
``encode_pocket`` (the embedding's protein-and-ligand intra pass and encoder
1), so it runs K1b, K2b and K3b besides the forward kernels.

The port trains at the config's ``train.compute_dtype``, as the JAX
package's ``main`` sets it for the whole run: bfloat16 (``Config()``'s and
``configs/gan_recipe.yml``'s) wherever every kernel of the path has a
bfloat16 instance, float32 where the config says so, and float32 with the
reason printed where a switch selects a kernel without one
(``train.loop.training_config``; ``GANTrainer`` refuses that case).
Parameters, the four Adam states and checkpoints stay float32; the
sampler's and ``sequence_logp``'s logits and log-probs are float32, as
JAX's. Deliberate differences from the JAX package: the sampler draws from a
``torch.Generator`` the caller passes, so its samples are not JAX's; the
WGAN-GP interpolation weights come from the same generator; ``--init-ckpt``
reads the port's own checkpoints. ``--vina-eval N`` samples the encoded batch
once more on the device after the final report and docks N of the samples
on the host (``rewards.vina_conditioning_host``): ``pct_vina_good``,
``n_vina_scored`` and ``vina_mean`` join the printed stats and
``metrics.jsonl``; the docking library is built before the first step, and
one that cannot be built raises there.

CLI: python -m singa_tpu_torch.train.gan --config configs/gan_recipe.yml \
       --data data/corpus --graph-loss wgan-gp --grammar-mask --batch-size 64
"""
from __future__ import annotations

import argparse
import functools
import math
import os
import time
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from singa_tpu_torch.chem.featurize import NODE_FEAT_DIM
from singa_tpu_torch.config import EOS_TOKEN, PAD_TOKEN, SOS_TOKEN, Config, load_config
from singa_tpu_torch.cpp import vina
from singa_tpu_torch.data.batch import ComplexBatch
from singa_tpu_torch.data.dataset import NpzDataset, SyntheticDataset
from singa_tpu_torch.dtypes import compute_dtype_scope
from singa_tpu_torch.generate import grammar
from singa_tpu_torch.models.discriminator import GINDiscriminatorDense, SeqDiscriminator
from singa_tpu_torch.models.singa import SINGA, binarize_props, cross_entropy_loss
from singa_tpu_torch.params import seeded_init
from singa_tpu_torch.train.checkpointing import CheckpointManager, save_config
from singa_tpu_torch.train.loop import MetricsWriter, check_precision, training_config
from singa_tpu_torch.train.optim import make_optimizer
from singa_tpu_torch.train.rewards import (
    chem_reward_host,
    chem_reward_host_shaped,
    graph_batch_host,
    validity_stats,
    vina_conditioning_host,
)


def adam(params, lr: float) -> torch.optim.Adam:
    """``optax.adam(lr)``: betas (0.9, 0.999), eps 1e-8 (the trainer's
    ``make_optimizer`` takes the config's betas, (0.99, 0.999)). The steps
    zero gradients in place (``set_to_none=False``), so a parameter whose
    gradient is zero in a later step still takes Adam's momentum step, as
    under optax."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``optax.sigmoid_binary_cross_entropy``, element-wise."""
    return -(labels * F.logsigmoid(logits) + (1.0 - labels) * F.logsigmoid(-logits))


def _categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw per row of softmax(logits) (Gumbel-max, as
    ``jax.random.categorical``)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


@torch.no_grad()
def sample_sequences(model: SINGA, enc, enc_pad, prop, generator: torch.Generator,
                     max_length: int, temperature: float = 1.0, grammar_mask: bool = False,
                     allow_dot: bool = False):
    """KV-cached autoregressive categorical sampling, drawn from
    ``generator`` (on the encoding's device). Returns (tokens [B, T] int64,
    logp [B, T] float32): SOS first; after a row's EOS every token is PAD
    with log-prob 0. The recorded log-prob is of the masked, untempered
    distribution. With ``grammar_mask`` the SMILES grammar and valence mask
    (``generate/grammar.py``) removes inadmissible tokens before the draw;
    a finished row's grammar state stays as it was."""
    B, T, dev = enc.shape[0], max_length, enc.device
    cache = model.prime_cache(enc, enc_pad, prop)
    tokens = torch.full((B, T), PAD_TOKEN, dtype=torch.long, device=dev)
    tokens[:, 0] = SOS_TOKEN
    logps = torch.zeros((B, T), dtype=torch.float32, device=dev)
    finished = torch.zeros((B,), dtype=torch.bool, device=dev)
    gram = grammar.init_state((B,), dev) if grammar_mask else None
    prev = tokens[:, :1]
    for t in range(1, T):
        logits = model.decode_token(prev, t - 1, cache).float()  # [B, V]
        if grammar_mask:
            logits = torch.where(grammar.allowed_tokens(gram, allow_dot=allow_dot), logits, -1e9)
        nxt = _categorical(logits / temperature, generator)
        logp = F.log_softmax(logits, dim=-1).gather(1, nxt[:, None])[:, 0]
        nxt = torch.where(finished, PAD_TOKEN, nxt)
        logps[:, t] = torch.where(finished, 0.0, logp)
        if grammar_mask:
            stepped = grammar.update(gram, nxt)
            keep = lambda new, old: torch.where(
                finished.reshape((B,) + (1,) * (new.dim() - 1)), old, new)
            gram = grammar.GrammarState(*(keep(n, o) for n, o in zip(stepped, gram)))
        tokens[:, t] = nxt
        finished = finished | (nxt == EOS_TOKEN)
        prev = nxt[:, None]
        if bool(finished.all()):  # the rest would be PAD with log-prob 0
            break
    return tokens, logps


def grammar_replay(tokens: torch.Tensor, allow_dot: bool = False) -> torch.Tensor:
    """The grammar mask before each token of tokens [B, L] (the grammar
    state machine replayed from its start): bool [B, L, V]."""
    gram = grammar.init_state((tokens.shape[0],), tokens.device)
    oks = []
    for i in range(tokens.shape[1]):
        oks.append(grammar.allowed_tokens(gram, allow_dot=allow_dot))
        gram = grammar.update(gram, tokens[:, i])
    return torch.stack(oks, dim=1)


def sequence_logp(model: SINGA, tokens: torch.Tensor, enc, enc_pad, prop,
                  grammar_mask: bool = False, allow_dot: bool = False) -> torch.Tensor:
    """Per-sequence log-prob [B] of sampled tokens [B, T] (SOS first) under
    the current policy, teacher-forced: what ``sample_sequences`` recorded,
    value and gradient, while the parameters are those it sampled with.
    With ``grammar_mask`` the log-probs are of the masked distribution.
    A position counts up to and including the first EOS."""
    logits = model.decode_step(tokens, enc, enc_pad, prop).float()[:, :-1]  # t-1 predicts t
    nxt = tokens[:, 1:].long()
    if grammar_mask:
        logits = torch.where(grammar_replay(nxt, allow_dot), logits, -1e9)
    lp = F.log_softmax(logits, dim=-1).gather(-1, nxt[..., None])[..., 0]
    is_eos = (nxt == EOS_TOKEN).long()
    live = (torch.cumsum(is_eos, dim=1) - is_eos) == 0
    return (lp * live).sum(dim=1)


class GANTrainer:
    """The adversarial round's models, optimizers and steps. ``init`` binds
    the generator and makes the discriminators and the three optimizers
    (Adam as ``optax.adam``); the state lives on the trainer. Each step
    (``sample``, ``d_step``, ``gd_step``, ``g_step`` and their evaluations)
    runs at the config's ``train.compute_dtype``."""

    def __init__(
        self,
        config: Config,
        g_lr: float = 1e-5,
        d_lr: float = 1e-4,
        extra_reward_fn: Optional[Callable] = "chem",
        temperature: float = 1.0,
        use_graph_disc: bool = True,
        graph_loss: str = "bce",  # 'bce' | 'wgan-gp'
        gp_weight: float = 10.0,
        grammar_mask: bool = False,
        d_label_smooth: float = 0.9,
    ):
        check_precision(config)
        if graph_loss not in ("bce", "wgan-gp"):
            raise ValueError(f"graph_loss {graph_loss!r}: 'bce' or 'wgan-gp'")
        self.config = config
        self.g_lr, self.d_lr = g_lr, d_lr
        # one-sided label smoothing of D's real targets keeps its sigmoid off
        # the rails, so G's reward keeps a gradient
        self.d_label_smooth = d_label_smooth
        # last measured D accuracies, for train_round's d_acc_cap
        self._last_d_acc: float | None = None
        self._last_gd_acc: float | None = None
        self.use_graph_disc = use_graph_disc
        self.graph_loss = graph_loss
        self.gp_weight = gp_weight
        self._graphs_host = functools.partial(
            graph_batch_host, n_max=config.shapes.num_ligand_nodes)
        if extra_reward_fn == "chem":
            extra_reward_fn = chem_reward_host
        elif extra_reward_fn == "chem-shaped":
            extra_reward_fn = chem_reward_host_shaped
        # host fn: np tokens [B, T] -> np rewards [B]
        self.extra_reward_fn = extra_reward_fn
        self.temperature = temperature
        # the grammar mask while sampling; the log-probs stay those of the
        # masked distribution, so the policy gradient stays on-policy
        self.grammar_mask = grammar_mask

    def init(self, generator: SINGA, seed: int) -> None:
        """Bind ``generator`` and make the discriminators on its device,
        seeded from ``seed`` (the sequence one) and ``seed + 1`` (the graph
        one), and the generator's and discriminators' optimizers."""
        self.generator = generator
        self.device = next(generator.parameters()).device
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.disc = SeqDiscriminator(self.config.model.decoder.vocab_size, device=self.device)
        seeded_init(self.disc, seed)
        self.g_opt = adam(generator.parameters(), self.g_lr)
        self.d_opt = adam(self.disc.parameters(), self.d_lr)
        self.graph_disc = self.gd_opt = None
        if self.use_graph_disc:
            self.graph_disc = GINDiscriminatorDense(NODE_FEAT_DIM, device=self.device)
            seeded_init(self.graph_disc, seed + 1)
            self.gd_opt = adam(self.graph_disc.parameters(), self.d_lr)
        self.step = 0

    @staticmethod
    def _real_graph(batch: ComplexBatch):
        """(x, dense adjacency, mask) of the batch's ligands from their
        covalent ll edges: masked edges dropped, symmetrised, clipped to 1."""
        n_l = batch.ligand.x.shape[1]
        idx = batch.ll.index.long().clamp(0, n_l - 1)  # a masked edge adds nothing
        src = F.one_hot(idx[..., 0], n_l).float() * batch.ll.mask[..., None].float()
        dst = F.one_hot(idx[..., 1], n_l).float()
        adj = torch.einsum("ben,bem->bnm", src, dst)
        adj = torch.clamp(adj + adj.transpose(1, 2), 0.0, 1.0)
        return batch.ligand.x, adj, batch.ligand.mask

    def _precision(self):
        """The compute-dtype scope every step runs in."""
        return compute_dtype_scope(self.config.train.compute_dtype)

    def _encode(self, batch: ComplexBatch):
        enc, pad = self.generator.encode_pocket(batch)
        cfg = self.config.model
        prop = binarize_props(batch, cfg.props) if cfg.num_props else None
        return enc, pad, prop

    @torch.no_grad()
    def sample(self, batch: ComplexBatch, generator: torch.Generator) -> torch.Tensor:
        with self._precision():
            enc, pad, prop = self._encode(batch)
            tokens, _ = sample_sequences(
                self.generator, enc, pad, prop, generator, self.config.model.decoder.tgt_len,
                self.temperature, grammar_mask=self.grammar_mask)
        return tokens

    # ------------- the sequence discriminator -------------

    def d_loss(self, real_tokens, fake_tokens):
        """BCE with the real targets smoothed; (loss, accuracy)."""
        real_logit, fake_logit = self.disc(real_tokens), self.disc(fake_tokens)
        loss = (sigmoid_bce(real_logit, torch.full_like(real_logit, self.d_label_smooth)).mean()
                + sigmoid_bce(fake_logit, torch.zeros_like(fake_logit)).mean())
        acc = 0.5 * ((real_logit > 0).float().mean() + (fake_logit < 0).float().mean())
        return loss, acc

    def d_step(self, batch: ComplexBatch, fake_tokens):
        self.d_opt.zero_grad(set_to_none=False)
        with self._precision():
            loss, acc = self.d_loss(batch.tokens.target, fake_tokens)
            loss.backward()
        self.d_opt.step()
        return loss.detach(), acc

    @torch.no_grad()
    def d_eval(self, batch: ComplexBatch, fake_tokens):
        with self._precision():
            return self.d_loss(batch.tokens.target, fake_tokens)

    # ------------- the graph discriminator -------------

    def gd_loss(self, real, fake, eps: torch.Tensor | None = None):
        """Loss and accuracy of the graph discriminator on the real (x, adj,
        mask) and the fake (x, mask, adj, valid) graphs. An invalid sample
        arrives as an empty graph with valid 0, and its terms are masked out.
        WGAN-GP takes the critic's gradient at graphs interpolated with
        weights ``eps`` [B, 1, 1] (adjacency included) and penalises its norm
        off 1, the gradient of a gradient."""
        rx, radj, rmask = real
        fx, fmask, fadj, fvalid = fake
        gdisc = self.graph_disc
        r_logit, f_logit = gdisc(rx, radj, rmask), gdisc(fx, fadj, fmask)
        w = fvalid / torch.clamp(fvalid.sum(), min=1.0)
        if self.graph_loss == "wgan-gp":
            critic = (f_logit * w).sum() - r_logit.mean()
            xi = (eps * rx + (1 - eps) * fx).detach().requires_grad_()
            ai = (eps * radj + (1 - eps) * fadj).detach().requires_grad_()
            train = torch.is_grad_enabled()  # gd_eval: the penalty's value only
            with torch.enable_grad():
                gx, ga = torch.autograd.grad(gdisc(xi, ai, rmask | fmask).sum(), (xi, ai),
                                             create_graph=train)
            gn = torch.sqrt((gx ** 2).sum(dim=(1, 2)) + (ga ** 2).sum(dim=(1, 2)) + 1e-12)
            loss = critic + self.gp_weight * ((gn - 1.0) ** 2).mean()
            acc = 0.5 * ((r_logit > f_logit.mean()).float().mean() + 0.5)
        else:
            loss = (sigmoid_bce(r_logit, torch.ones_like(r_logit)).mean()
                    + (sigmoid_bce(f_logit, torch.zeros_like(f_logit)) * w).sum())
            acc = 0.5 * ((r_logit > 0).float().mean()
                         + ((f_logit < 0).float() * fvalid).sum() / torch.clamp(fvalid.sum(), min=1.0))
        return loss, acc

    def gd_step(self, batch: ComplexBatch, fake, eps=None):
        self.gd_opt.zero_grad(set_to_none=False)
        with self._precision():
            loss, acc = self.gd_loss(self._real_graph(batch), fake, eps)
            loss.backward()
        self.gd_opt.step()
        return loss.detach(), acc

    @torch.no_grad()
    def gd_eval(self, batch: ComplexBatch, fake, eps=None):
        with self._precision():
            return self.gd_loss(self._real_graph(batch), fake, eps)

    # ------------- the generator -------------

    def g_loss(self, batch: ComplexBatch, tokens, chem_r, fake):
        """REINFORCE surrogate; returns (loss, mean reward, valid share or
        nan without the graph discriminator)."""
        enc, pad, prop = self._encode(batch)
        seq_logp = sequence_logp(self.generator, tokens, enc, pad, prop,
                                 grammar_mask=self.grammar_mask)
        with torch.no_grad():  # the rewards weigh the log-probs, no gradient
            reward = torch.sigmoid(self.disc(tokens))
            pct_valid = torch.tensor(math.nan)
            if self.graph_disc is not None:
                fx, fmask, fadj, fvalid = fake
                reward = reward + torch.sigmoid(self.graph_disc(fx, fadj, fmask)) * fvalid
                pct_valid = fvalid.mean()
            if chem_r is not None:
                reward = reward + chem_r
            advantage = reward - reward.mean()
        return -(advantage * seq_logp).mean(), reward.mean(), pct_valid

    def g_step(self, batch: ComplexBatch, tokens, chem_r, fake):
        self.g_opt.zero_grad(set_to_none=False)
        with self._precision():
            loss, reward, pct_valid = self.g_loss(batch, tokens, chem_r, fake)
            loss.backward()
        self.g_opt.step()
        self.step += 1
        return loss.detach(), reward, pct_valid

    # ------------- the round -------------

    def _host_bridge(self, tokens: torch.Tensor):
        """Device tokens -> (chem rewards [B] or None, fake graph batch (x,
        mask, adj, valid) or None), on the device."""
        tokens_np = tokens.cpu().numpy()
        dev = self.device
        chem_r = (torch.as_tensor(self.extra_reward_fn(tokens_np), device=dev)
                  if self.extra_reward_fn is not None else None)
        fake = (tuple(torch.as_tensor(a, device=dev) for a in self._graphs_host(tokens_np))
                if self.use_graph_disc else None)
        return chem_r, fake

    def _eps(self, batch: ComplexBatch, generator: torch.Generator):
        if self.graph_loss != "wgan-gp":
            return None
        return torch.rand((batch.batch_size, 1, 1), generator=generator, device=self.device)

    def train_round(self, batch: ComplexBatch, generator: torch.Generator, d_steps: int = 1,
                    g_steps: int = 1, d_acc_cap: float = 1.0) -> dict:
        """One adversarial round: sample -> host chemistry -> D, graph-D, G.

        The same samples feed the discriminator updates and the first
        generator update (on-policy: the generator is unchanged until its
        step); further g_steps sample again. ``d_acc_cap`` < 1 pauses a
        discriminator's updates while its last measured accuracy exceeds
        the cap; its loss and accuracy are still evaluated and logged every
        round, so the pause ends as soon as G catches up."""
        metrics = {}
        tokens = self.sample(batch, generator)
        chem_r, fake = self._host_bridge(tokens)
        pause_d = self._last_d_acc is not None and self._last_d_acc > d_acc_cap
        pause_gd = self._last_gd_acc is not None and self._last_gd_acc > d_acc_cap
        for i in range(d_steps):
            if pause_d:
                d_loss, d_acc = self.d_eval(batch, tokens)
            else:
                d_loss, d_acc = self.d_step(batch, tokens)
            metrics["gan/d_loss"] = float(d_loss)
            metrics["gan/d_acc"] = float(d_acc)
            metrics["gan/d_paused"] = float(pause_d)
            if self.graph_disc is not None:
                eps = self._eps(batch, generator)
                if pause_gd:
                    gd_loss, gd_acc = self.gd_eval(batch, fake, eps)
                else:
                    gd_loss, gd_acc = self.gd_step(batch, fake, eps)
                metrics["gan/gd_loss"] = float(gd_loss)
                metrics["gan/gd_acc"] = float(gd_acc)
                metrics["gan/gd_paused"] = float(pause_gd)
                self._last_gd_acc = float(gd_acc)
            self._last_d_acc = float(d_acc)
            pause_d = d_acc_cap < 1.0 and self._last_d_acc > d_acc_cap
            pause_gd = (d_acc_cap < 1.0 and self._last_gd_acc is not None
                        and self._last_gd_acc > d_acc_cap)
            if i + 1 < d_steps:  # fresh negatives for the next D update
                tokens = self.sample(batch, generator)
                chem_r, fake = self._host_bridge(tokens)
        for i in range(g_steps):
            if i > 0:  # stay on-policy after the parameter update
                tokens = self.sample(batch, generator)
                chem_r, fake = self._host_bridge(tokens)
            g_loss, reward, pct_valid = self.g_step(batch, tokens, chem_r, fake)
            metrics["gan/g_loss"] = float(g_loss)
            metrics["gan/reward"] = float(reward)
            if self.use_graph_disc:
                metrics["gan/pct_valid"] = float(pct_valid) * 100.0
        return metrics


def _count(text: str) -> int:
    n = int(text)
    if n < 0:
        raise argparse.ArgumentTypeError(f"a count >= 0, not {n}")
    return n


def main(argv=None):
    """GAN CLI: CE warm-up (optional), then alternating adversarial rounds;
    writes ``metrics.jsonl``, ``config.yml`` and the final generator
    checkpoint into ``--logdir``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", type=str, default=None)
    ap.add_argument("--logdir", type=str, default="runs/gan")
    ap.add_argument("--data", type=str, default=None)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--d-steps", type=int, default=1)
    ap.add_argument("--g-steps", type=int, default=1)
    ap.add_argument("--pretrain", type=int, default=0, help="CE warmup steps")
    ap.add_argument(
        "--init-ckpt", type=str, default=None,
        help="the port's train-run dir (or its checkpoints/ subdir) to restore the "
        "pretrained generator from: BASELINE configs[3], full CE pretrain then "
        "adversarial finetune",
    )
    ap.add_argument(
        "--eval-every", type=int, default=0,
        help="every N rounds, decode a sample batch and log "
        "validity/uniqueness/QED/SA to metrics.jsonl (quality trajectory)",
    )
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--graph-loss", type=str, default="bce", choices=["bce", "wgan-gp"])
    ap.add_argument("--no-graph-disc", action="store_true")
    ap.add_argument(
        "--d-acc-cap", type=float, default=0.95,
        help="pause discriminator updates while its accuracy exceeds this "
        "(anti-saturation; 1.0 disables)",
    )
    ap.add_argument(
        "--d-label-smooth", type=float, default=0.9,
        help="one-sided label smoothing target for D's real examples",
    )
    ap.add_argument(
        "--vina-eval", type=_count, default=0,
        help="at the final report, dock N sampled molecules into their "
        "conditioning pockets (native engine, on the host) and log the "
        "vina < -7.5 pass-rate",
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--grammar-mask", action="store_true",
        help="mask REINFORCE sampling with the SMILES grammar/valence mask",
    )
    ap.add_argument(
        "--shaped-reward", action="store_true",
        help="dense-gradient chemistry reward (monotone in QED/SA below the "
        "conditioning thresholds) instead of the pure threshold form",
    )
    ap.add_argument("--device", type=str, default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda asked for, but CUDA is not available")
    if args.vina_eval:
        vina.build()  # a library that cannot be built raises before any training
    # the config's precision for the whole run, as JAX's main sets it
    cfg, precision = training_config(load_config(args.config) if args.config else Config())
    print(f"config: {args.config or 'Config()'} with {precision}")
    if args.synthetic or not args.data:
        data = SyntheticDataset(args.batch_size, cfg.shapes, cfg.model.decoder.tgt_len)
    else:
        data = NpzDataset(os.path.join(args.data, "train"), args.batch_size)
    it = iter(data)
    batch = next(it).to(device)

    generator = SINGA(cfg, device=device, seed=args.seed)
    if args.init_ckpt:
        d = args.init_ckpt
        if os.path.isdir(os.path.join(d, "checkpoints")):
            d = os.path.join(d, "checkpoints")
        restored = CheckpointManager(d).restore(generator) if os.path.isdir(d) else None
        if restored is None:
            raise FileNotFoundError(f"no checkpoint under {d}")
        print(f"restored generator from {d} @ step {restored[0]}")

    if args.pretrain:
        opt = adam(generator.parameters(), 1e-4)
        for _ in range(args.pretrain):
            b = next(it).to(device)
            opt.zero_grad(set_to_none=False)
            with compute_dtype_scope(cfg.train.compute_dtype):
                ce = cross_entropy_loss(generator(b), b.tokens.target)
                ce.backward()
            opt.step()
        print(f"pretrain done: CE={ce.item():.3f}")

    trainer = GANTrainer(
        cfg,
        use_graph_disc=not args.no_graph_disc,
        graph_loss=args.graph_loss,
        grammar_mask=args.grammar_mask,
        d_label_smooth=args.d_label_smooth,
        extra_reward_fn="chem-shaped" if args.shaped_reward else "chem",
    )
    trainer.init(generator, args.seed + 1)
    save_config(args.logdir, cfg)
    writer = MetricsWriter(args.logdir)
    rng = torch.Generator(device=device).manual_seed(args.seed)

    def sample_quality():
        """validity/uniqueness/QED/SA of a sampled batch (host)."""
        return validity_stats(trainer.sample(batch, rng).cpu().numpy())

    t0 = time.time()
    for r in range(1, args.rounds + 1):
        metrics = trainer.train_round(next(it).to(device), rng, args.d_steps, args.g_steps,
                                      d_acc_cap=args.d_acc_cap)
        if args.eval_every and (r == 1 or r % args.eval_every == 0):
            metrics.update({f"quality/{k}": v for k, v in sample_quality().items()})
        writer.write(r, **metrics)
        if r == 1 or r % 5 == 0:
            print(f"round {r}: "
                  + " ".join(f"{k.split('/')[1]}={v:.3f}" for k, v in metrics.items())
                  + f" ({(time.time() - t0) / r:.1f}s/round)")
    stats = sample_quality()
    if args.vina_eval:
        stats.update(vina_conditioning_host(batch, trainer.sample(batch, rng),
                                            n_eval=args.vina_eval))
    print("sample stats:", stats)
    writer.write(args.rounds + 1, **{f"quality/{k}": v for k, v in stats.items()})
    writer.close()
    # the fine-tuned generator, with a fresh optimizer state of the trainer's
    # shape, so generate --checkpoint and gan --init-ckpt read it back
    CheckpointManager(os.path.join(args.logdir, "checkpoints")).save(
        args.rounds, generator, make_optimizer(generator.parameters(), cfg.train.optimizer))
    print(f"saved generator -> {args.logdir}/checkpoints @ round {args.rounds}")


if __name__ == "__main__":
    main()
