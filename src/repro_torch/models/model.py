"""Public model API: build_model(cfg, device) -> Model with init / forward /
loss_fn / init_cache / prefill / decode_step / count_params.

Counterpart of `repro.models.model`, for every family of the configs:
dense, audio, MoE (MLA or GQA attention), hybrid (zamba2: Mamba2 blocks),
xLSTM (mLSTM / sLSTM blocks) and the VLM (gated cross-attention layers).

Input contract per cfg.input_kind (`loss_fn` also reads "labels" (B, S)
int, negative where masked):
  tokens        batch = {"tokens" (B, S) int}
  frames        batch = {"frames" (B, S, frame_dim) float} (audio:
                precomputed frame embeddings; encoder-only, no decode)
  tokens+image  batch = {"tokens", "image_embeds" (B, image_tokens, D)
                float}: precomputed patch embeddings, projected by
                `img_proj` (an exact `dense`) into the cross-attention
                layers' keys and values. A batch without them raises
                KeyError, as the reference's does; `decode_step` reads the
                image keys and values from the caches that `prefill` left.

The model runs on `device` (the CUDA card for None) in the config's dtype.
Its quantized linears take `impl` ('auto': the Hopper kernels on the card,
the reference's semantics on the CPU; 'reference' keeps the reference's
semantics on any device, which on the card runs each kernel's plain
version for the limb family and the float32-summing LNS route).
`forward` returns the logits and the MoE layers' summed aux loss;
`loss_fn` the reference's training loss: token cross-entropy over the
unmasked labels, the z-loss at 1e-4 and the aux loss at 1e-2.

On a mesh (`runtime.sharding.activation_sharding_ctx`) the embedding, the
projections and the head gather their FSDP blocks where they are used,
as the layers do (`core.collectives.fsdp_gather`), and split over the
vocab where "model" divides it, as the reference's logits are
(`vocab_split`): the head is column-parallel and its logits this rank's
vocab block; the table, where `emb_vocab_sharded`, is looked up on this
rank's rows and the partial embeddings summed over "model". `loss_fn`
takes the logsumexp over the split vocab (a max all-reduce, then a sum
all-reduce) and the label's logit from the rank that holds it (a sum
all-reduce); `forward`, `prefill` and `decode_step` gather the logits
over "model".
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.core.platform import resolve_device
from repro_torch.core.collectives import (
    all_reduce,
    all_reduce_rows,
    copy_to_model,
    fsdp_gather,
    gather_from_model,
    gather_params,
    model_split,
    reduce_from_model,
    row_groups,
    rows_are_split,
)
from repro_torch.core.quant import f32
from repro_torch.models.layers import dense, dense_init
from repro_torch.models.transformer import backbone_apply, backbone_init, init_caches

Params = dict[str, Any]


class Model(NamedTuple):
    cfg: Any
    device: torch.device
    init: Callable[..., Params]                # (generator) -> params
    forward: Callable[..., tuple]              # (params, batch) -> (logits, aux)
    loss_fn: Callable[..., tuple]              # (params, batch) -> (loss, metrics)
    init_cache: Callable[..., list]            # (batch_size, s_max) -> caches
    prefill: Callable[..., tuple]              # -> (logits, caches, cache_len)
    decode_step: Callable[..., tuple]          # -> (logits, caches, cache_len)
    count_params: Callable[[Params], int]


def _embed_init(gen: torch.Generator, cfg) -> Params:
    p: Params = {}
    if cfg.input_kind == "frames":
        p["frame_proj"] = dense_init(gen, cfg.frame_dim, cfg.d_model)
    else:
        p["emb"] = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                               dtype=torch.float32, device=gen.device).mul_(0.02)
    if cfg.input_kind == "tokens+image":
        p["img_proj"] = dense_init(gen, cfg.d_model, cfg.d_model)
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, cfg.d_model, cfg.vocab_size,
                               scale=1.0 / cfg.d_model**0.5)
    return p


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [leaf for item in items for leaf in _leaves(item)]


def build_model(cfg, device: str | torch.device | None = None, *,
                impl: str = "auto") -> Model:
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)

    def as_tensor(a, dt=None) -> torch.Tensor:
        return torch.as_tensor(a).to(dev, dt)

    def vocab_split(head: bool):
        """The "model" axis the head's (`head`) or the table's vocab splits
        over, else None: the table where `emb_vocab_sharded` (the tied head
        is the table), the untied head wherever the vocab divides."""
        if head and not cfg.tie_embeddings:
            return model_split(cfg.vocab_size)
        return model_split(cfg.vocab_size) if cfg.emb_vocab_sharded else None

    def lookup(params: Params, tokens) -> torch.Tensor:
        """The float32 embeddings of `tokens`, cast to the model dtype: a
        gather of the float32 table then one cast == the reference's cast
        of the whole table then a gather."""
        tokens = as_tensor(tokens, torch.long)
        m = vocab_split(head=False)
        emb = fsdp_gather(params["emb"], 0 if m else None)
        if m is None:
            return emb[tokens].to(dtype)
        rows = emb.shape[0]
        local = tokens - m.index * rows
        held = (local >= 0) & (local < rows)
        part = torch.where(held[..., None], emb[local.clamp(0, rows - 1)], 0.0)
        return reduce_from_model(part, m).to(dtype)

    def embed(params: Params, batch: dict) -> tuple[torch.Tensor, torch.Tensor | None]:
        """-> (x (B, S, D), the projected image embeddings or None)."""
        if cfg.input_kind == "frames":
            return dense(gather_params(params["frame_proj"]),
                         as_tensor(batch["frames"], dtype)), None
        x = lookup(params, batch["tokens"])
        img = None
        if cfg.input_kind == "tokens+image":
            img = dense(gather_params(params["img_proj"]), as_tensor(batch["image_embeds"], dtype))
        return x, img

    def logits_of(params: Params, h: torch.Tensor, whole: bool = True) -> torch.Tensor:
        """The logits of h; with a vocab split this rank's vocab block,
        gathered over "model" when `whole`."""
        m = vocab_split(head=True)
        hp = copy_to_model(h, m)
        if cfg.tie_embeddings:
            logits = hp @ fsdp_gather(params["emb"], 0 if m else None).to(h.dtype).T
        else:
            logits = dense(gather_params(params["head"], {"w": 1, "b": 0} if m else None), hp)
        return gather_from_model(logits, m, logits.ndim - 1) if whole else logits

    def init(gen: torch.Generator) -> Params:
        if torch.device(gen.device).type != dev.type:
            raise ValueError(f"generator on {gen.device}, model on {dev}")
        return {**_embed_init(gen, cfg), "backbone": backbone_init(gen, cfg)}

    def forward(params: Params, batch: dict, whole: bool = True
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """-> (logits (B, S, V), the MoE aux loss, 0 without MoE layers);
        with a vocab split and not `whole`, this rank's vocab block."""
        x, img = embed(params, batch)
        b, s = x.shape[:2]
        positions = torch.arange(s, dtype=torch.int32, device=dev)[None, :].expand(b, s)
        h, _, aux = backbone_apply(params["backbone"], cfg, x, positions=positions,
                                   image_embeds=img, impl=impl)
        return logits_of(params, h, whole), aux

    def split_nll(logits: torch.Tensor, labels: torch.Tensor, m) -> tuple:
        """(logsumexp, -log p(label)) over the vocab split over `m`, from
        this rank's vocab block of the logits (module docstring)."""
        lf = logits.to(torch.float32)
        top = all_reduce(lf.detach().amax(-1), "max", m)
        lse = top + torch.log(reduce_from_model(torch.exp(lf - top[..., None]).sum(-1), m))
        rows = logits.shape[-1]
        local = labels - m.index * rows
        held = (local >= 0) & (local < rows)
        src = logits if cfg.fused_lse_loss else lf
        picked = src.gather(-1, local.clamp(0, rows - 1)[..., None])[..., 0]
        picked = reduce_from_model(torch.where(held, picked, torch.zeros_like(picked)), m)
        return lse, lse - picked.to(torch.float32)

    def loss_fn(params: Params, batch: dict) -> tuple[torch.Tensor, dict]:
        """-> (the 0-d float32 loss, {"ce", "z_loss", "moe_aux"}): the mean
        cross-entropy over labels >= 0, plus 1e-4 x the mean squared
        logsumexp (the z-loss) and 1e-2 x the MoE aux loss. Under
        `cfg.fused_lse_loss` one logsumexp serves both and the label's logit
        is gathered in the logits' dtype (the reference's one-hot
        contraction, which adds that one logit to zeros); else the
        log-softmax in float32. A masked label's term is multiplied by 0, so
        its gathered position (clamped to 0) never counts.

        While a meshed step splits the rows over its row axes
        (`core.collectives.rows_are_split`), each rank's batch is its rows
        of the global batch, and the loss and each metric are this rank's
        share of the global ones, which sum over the row blocks to them:
        the masked sum over the global count of labels >= 0 (an
        all-reduce), the z-loss sum over the global token count, the aux
        loss over the row blocks' number (each rank's mean is over as many
        whole chunks). With the vocab split over "model", see `split_nll`."""
        logits, aux = forward(params, batch, whole=False)
        labels = as_tensor(batch["labels"], torch.long)
        mask = (labels >= 0).to(torch.float32)
        m = vocab_split(head=True)
        if m is not None:
            lse, nll = split_nll(logits, labels, m)
        else:
            idx = labels.clamp(min=0)[..., None]
            lse = torch.logsumexp(logits.to(torch.float32), dim=-1)            # (B, S)
            if cfg.fused_lse_loss:
                nll = lse - logits.gather(-1, idx)[..., 0].to(torch.float32)
            else:
                logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
                nll = -logp.gather(-1, idx)[..., 0]
        if rows_are_split():
            world = row_groups()
            count = all_reduce_rows(mask.sum())
            zl = 1e-4 * (torch.square(lse).sum() / f32(lse.numel() * world, lse))
            loss = (nll * mask).sum() / torch.clamp(count, min=1.0)
            aux = aux / f32(world, aux)
        else:
            zl = 1e-4 * torch.square(lse).mean()
            loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        total = loss + zl + 1e-2 * aux
        return total, {"ce": loss, "z_loss": zl, "moe_aux": aux}

    def init_cache(batch_size: int, s_max: int) -> list:
        return init_caches(cfg, batch_size, s_max, dtype, dev)

    def prefill(params: Params, batch: dict, caches) -> tuple:
        """Returns (last-position logits (B, 1, V), caches, cache_len)."""
        x, img = embed(params, batch)
        b, s = x.shape[:2]
        positions = torch.arange(s, dtype=torch.int32, device=dev)[None, :].expand(b, s)
        cache_len = torch.zeros((b,), dtype=torch.int32, device=dev)
        h, new_caches, _ = backbone_apply(params["backbone"], cfg, x,
                                          positions=positions, caches=caches,
                                          cache_len=cache_len, image_embeds=img,
                                          impl=impl)
        return logits_of(params, h[:, -1:, :]), new_caches, cache_len + s

    def decode_step(params: Params, tokens, caches, cache_len: torch.Tensor,
                    image_embeds=None) -> tuple:
        """tokens (B, 1) -> (logits (B, 1, V), caches, cache_len). The
        reference's signature: `image_embeds` is accepted and not needed,
        since the cross-attention layers decode from the image keys and
        values in their caches (the reference projects it and leaves the
        projection unused)."""
        if cfg.input_kind == "frames":
            raise ValueError(f"{cfg.name} is encoder-only: no decode step")
        tokens = as_tensor(tokens, torch.long)
        x = lookup(params, tokens)
        positions = cache_len[:, None] + torch.zeros_like(tokens, dtype=torch.int32)
        h, new_caches, _ = backbone_apply(params["backbone"], cfg, x,
                                          positions=positions, caches=caches,
                                          cache_len=cache_len, decode=True, impl=impl)
        return logits_of(params, h), new_caches, cache_len + tokens.shape[1]

    def count_params(params: Params) -> int:
        """Every parameter, zamba2's `shared_block` included."""
        return int(sum(t.numel() for t in _leaves(params)))

    return Model(cfg, dev, init, forward, loss_fn, init_cache, prefill, decode_step,
                 count_params)


def input_specs(cfg, shape, device: str | torch.device = "cpu") -> dict:
    """Empty tensors of every model input of one shape cell, with the
    reference's shapes and dtypes (`repro.models.model.input_specs`): under
    `FakeTensorMode` they are fake, and hold no storage."""
    b, s = shape.global_batch, shape.seq_len

    def mk(sh, dt):
        return torch.empty(sh, dtype=dt, device=device)
    if shape.kind == "decode":
        return {"tokens": mk((b, 1), torch.int32)}
    if cfg.input_kind == "frames":
        return {"frames": mk((b, s, cfg.frame_dim), torch.float32),
                "labels": mk((b, s), torch.int32)}
    batch = {"tokens": mk((b, s), torch.int32), "labels": mk((b, s), torch.int32)}
    if cfg.input_kind == "tokens+image":
        batch["image_embeds"] = mk((b, cfg.image_tokens, cfg.d_model), torch.float32)
    return batch


__all__ = ["Model", "build_model", "input_specs"]
