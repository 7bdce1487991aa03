"""The MFP model, its training forward and its eval forward (PyTorch).

Counterpart of ``flexdm_tpu/models/mfp.py``:

* :class:`MFPModel` is Encoder -> Blocks -> Decoder, over one token per
  element (``seq_type='default'``) or one token per (element, field)
  (``seq_type='flat'``, the VanillaTransformer);
* :func:`forward_train` shuffles or sorts the elements where the model's
  ``input_dtype`` asks for it, masks the batch per sampled task, runs the
  network (with dropout when training) and scores it with
  ``compute_mfp_loss`` (rico: ``pos`` scored on sorted elements); every
  random number comes in through :class:`~.masking.TrainDraws`;
* :func:`forward_eval` applies externally supplied masks, runs the network
  once or decodes with :func:`iterative_decode` (MaskGIT), and merges
  ground truth back onto the unmasked fields.

``dtype="bfloat16"`` is the JAX package's mixed precision: the encoder,
the blocks and the decoder compute in bf16 where flax does (see
:mod:`.transformer`), parameters stay float32, and the losses cast every
prediction to float32.  MaskGIT's confidences are taken in the logits'
dtype, as in JAX, so bf16 confidences can tie exactly; every tied field at
the threshold is committed.

``remat=True`` recomputes each block in the backward
(:class:`~.transformer.Blocks`), as JAX's ``MFPModel(remat=True)`` does;
``attention_impl`` goes to every block's attention, as JAX's does.

The baselines (:mod:`.baselines`) go through the same two functions, by
way of :func:`apply_model`: they also take the targets (teacher forcing)
and the masks (the decode's ground-truth merge) and return auxiliary
losses, which :func:`forward_train` adds to the loss.  An autoregressive
baseline (``is_autoreg``) has its elements shuffled and the elem task pick
the last element; their deterministic forward is a sequential decode
(validation runs it too, as in JAX), and ``forward_eval`` ignores
``num_iter`` for them, as JAX's does.  Attributes a baseline lacks are
read with the JAX package's defaults (``input_dtype`` ``"set"``,
``is_autoreg`` and ``use_elemwise_noise`` False).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..data.schema import Schema, make_task_probs
from .decoder import Decoder
from .encoder import Encoder
from .losses import compute_mfp_loss
from .masking import (
    TrainDraws,
    apply_token,
    filter_padding,
    get_seq_mask,
    merge_inputs_and_prediction,
    preprocess_for_test,
    preprocess_for_train,
)
from .sorting import shuffle_inputs, sort_inputs
from .transformer import Blocks

Tensors = Dict[str, torch.Tensor]

INPUT_DTYPES = ("set", "shuffled_set", "sorted_set")
# Compute dtypes (``--dtype``) and the torch dtype each computes in (None:
# float32 throughout); the attention kernels have instances for these.
COMPUTE_DTYPES = {None: None, "float32": None, "bfloat16": torch.bfloat16}


def compute_dtype(dtype: Optional[str]) -> Optional[torch.dtype]:
    """The torch compute dtype of a ``--dtype`` value; another value raises
    ``NotImplementedError``."""
    if dtype not in COMPUTE_DTYPES:
        raise NotImplementedError(
            f"dtype={dtype!r} is not in this port: it computes in "
            f"{sorted(k for k in COMPUTE_DTYPES if k)}")
    return COMPUTE_DTYPES[dtype]


class MFPModel(nn.Module):
    """Encoder -> Blocks -> Decoder (flexdm_tpu/models/mfp.py:51-112)."""

    def __init__(self, schema: Schema, latent_dim: int = 256,
                 num_blocks: int = 4, block_type: str = "deepsvg",
                 num_heads: int = 8, dropout: float = 0.1,
                 context: Optional[str] = None, input_dtype: str = "set",
                 seq_type: str = "default", use_elemwise_noise: bool = False,
                 dtype: Optional[str] = None, remat: bool = False,
                 attention_impl: str = "auto"):
        super().__init__()
        compute = compute_dtype(dtype)
        if input_dtype not in INPUT_DTYPES:
            raise ValueError(f"input_dtype {input_dtype!r} not in "
                             f"{INPUT_DTYPES}")
        if seq_type == "flat":
            if input_dtype != "shuffled_set":
                raise ValueError("seq_type 'flat' needs input_dtype "
                                 f"'shuffled_set', got {input_dtype!r}")
            fusion = detachment = "flat"
        elif seq_type == "default":
            fusion, detachment = "add", "default"
        else:
            raise ValueError(f"seq_type {seq_type!r}")
        self.schema = schema
        self.context = context
        self.input_dtype = input_dtype
        self.seq_type = seq_type
        self.use_elemwise_noise = use_elemwise_noise
        self.dtype = dtype
        self.encoder = Encoder(schema, latent_dim, context, input_dtype,
                               fusion, dropout, use_elemwise_noise, compute)
        self.blocks = Blocks(
            latent_dim=latent_dim, num_blocks=num_blocks,
            block_type=block_type, num_heads=num_heads, dropout=dropout,
            dtype=compute, remat=remat, attention_impl=attention_impl,
        )
        self.decoder = Decoder(schema, latent_dim, context, detachment,
                               compute)

    def forward(self, inputs: Tensors,
                generator: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None) -> Tensors:
        """Predictions per field; dropout draws from ``generator`` (none:
        no dropout); ``noise`` is a ``use_elemwise_noise`` model's draw."""
        seq, seq_mask = self.encoder(inputs, generator, noise)
        return self.decoder(self.blocks(seq, seq_mask, generator))

    def draw_options(self) -> Dict:
        return draw_options(self)


def draw_options(model: nn.Module) -> Dict:
    """The :func:`~.masking.draw_train` options of ``model`` (the oneshot
    model or a baseline): the shuffle uniforms and the noise's sequence
    length, where needed."""
    noise_length = None
    if getattr(model, "use_elemwise_noise", False):
        token = model.context in ("id", "length", "canvas")
        noise_length = model.schema.max_length + int(token)
    shuffle = (getattr(model, "is_autoreg", False)
               or getattr(model, "input_dtype", "set") == "shuffled_set")
    return dict(shuffle=shuffle, noise_length=noise_length)


@dataclasses.dataclass(frozen=True)
class TaskConfig:
    """Static per-run task configuration."""

    task_probs: Tuple[float, ...]
    sort_pos: bool
    pos_task_id: int


def make_task_config(schema: Schema, masking_method: str) -> TaskConfig:
    return TaskConfig(
        task_probs=tuple(make_task_probs(schema, masking_method)),
        sort_pos=schema.sort_pos,
        pos_task_id=schema.task_names.index("pos"),
    )


def forward_train(model: nn.Module, inputs: Tensors, draws: TrainDraws,
                  task_config: TaskConfig, train: bool = True,
                  sample_weight: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One training forward: order the elements, mask per task, predict,
    score.  Returns ``(loss, metrics)``.  ``train=False`` keeps the random
    task masking (that is how the reference validates) but turns dropout
    off (and runs a baseline deterministically); ``sample_weight`` (B,)
    zeroes batch-padding rows.  A baseline's auxiliary terms join the
    metrics, and those named ``*_loss`` join the loss."""
    schema = model.schema
    is_autoreg = getattr(model, "is_autoreg", False)
    input_dtype = getattr(model, "input_dtype", "set")
    if is_autoreg or input_dtype == "shuffled_set":
        if draws.shuffle is None:
            raise ValueError("a shuffled model needs draws.shuffle")
        inputs = shuffle_inputs(inputs, schema, draws.shuffle)
    elif input_dtype == "sorted_set":
        inputs = sort_inputs(inputs, schema)
    sort_flag = None
    if task_config.sort_pos:
        sort_flag = draws.tasks == task_config.pos_task_id
    targets, modified, masks = preprocess_for_train(
        inputs, schema, draws.tasks, draws.uniforms, draws.element,
        draws.values, is_autoreg=is_autoreg,
    )
    outputs, aux = apply_model(
        model, modified, targets, masks, deterministic=not train,
        dropout=draws.dropout if train else None, vae=draws.vae,
        noise=draws.noise)
    loss, metrics = compute_mfp_loss(
        schema, targets, outputs, masks, sort_flag=sort_flag,
        sample_weight=sample_weight,
    )
    for name, value in aux.items():
        metrics[name] = value
        if name.endswith("_loss"):
            loss = loss + value
    metrics["loss"] = loss
    return loss, metrics


def apply_model(model: nn.Module, modified: Tensors, targets: Tensors,
                masks: Tensors, deterministic: bool,
                dropout: Optional[torch.Generator] = None,
                vae: Optional[torch.Generator] = None,
                noise: Optional[torch.Tensor] = None
                ) -> Tuple[Tensors, Dict[str, torch.Tensor]]:
    """``(outputs, aux)`` of the oneshot model (which reads only the
    masked inputs, and ``noise``; ``aux`` is empty) or of a baseline (which
    also reads the targets, the masks and the ``vae`` generator)
    (flexdm_tpu/models/mfp.py:198-222)."""
    if isinstance(model, MFPModel):
        return model(modified, dropout, noise), {}
    return model(modified, targets, masks, deterministic, dropout, vae)


@torch.no_grad()
def forward_eval(model: nn.Module, inputs: Tensors, masks: Tensors,
                 tasks: Optional[torch.Tensor] = None, num_iter: int = 1,
                 rounds: Optional[List[Dict]] = None) -> Tensors:
    """Masked inputs -> predictions with ground truth merged back.
    ``num_iter > 1`` decodes the oneshot model with
    :func:`iterative_decode` (``rounds`` collects its rounds); below 2 it
    is one pass.  A baseline runs its deterministic forward (a sequential
    decode for the autoregressive ones) whatever ``num_iter`` is."""
    if getattr(model, "use_elemwise_noise", False):
        # JAX's forward_eval gives such a model no noise rng either.
        raise ValueError("forward_eval: a use_elemwise_noise model has no "
                         "eval behaviour (it draws noise only in training)")
    modified = preprocess_for_test(inputs, model.schema, masks, tasks)
    if not isinstance(model, MFPModel):
        outputs = apply_model(model, modified, inputs, masks,
                              deterministic=True)[0]
    elif num_iter > 1:
        outputs = iterative_decode(model, masks, inputs, modified, num_iter,
                                   rounds)
    else:
        outputs = model(modified)
    return merge_inputs_and_prediction(inputs, model.schema, masks, outputs)


def iterative_decode(model: MFPModel, masks: Tensors, inputs: Tensors,
                     modified_inputs: Tensors, num_iter: int,
                     rounds: Optional[List[Dict]] = None) -> Tensors:
    """MaskGIT decoding (flexdm_tpu/models/mfp.py:254-337).

    Each of ``num_iter`` rounds runs the model, scores every still-masked
    categorical field by its confidence (the channel mean of the max
    softmax probability; 0 where the field is not masked), takes the
    threshold at position ``round(num_masked / num_iter)`` (clipped) of the
    confidences sorted descending, commits the argmax of every field at or
    above it, and re-masks the rest.  A categorical field keeps the
    outputs of the round that committed it (round 0's if none did);
    numerical fields take the last round's.  ``rounds``, if given,
    receives per round ``{"confidence": {name: (B, S)}, "threshold":
    (B,)}``.
    """
    schema = model.schema
    masks = dict(masks)
    seq_mask = get_seq_mask(inputs["length"], schema.max_length)
    filtered = filter_padding(inputs, schema, seq_mask)
    cat_cols = [c for c in schema.modeled
                if c.is_sequence and c.is_categorical]
    num_masked = sum(masks[c.name].to(torch.int32).sum(-1) for c in cat_cols)
    # int / int -> float32, then round half to even, as in JAX.
    num_update = torch.round(
        num_masked.to(torch.float32) / num_iter).to(torch.int32)

    modified = dict(modified_inputs)
    final_outputs: Tensors = {}
    outputs: Tensors = {}
    for i in range(num_iter):
        outputs = model(modified)
        if i == 0:
            final_outputs = dict(outputs)
        confidence = {
            c.name: torch.where(
                masks[c.name],
                torch.softmax(outputs[c.name], -1).amax(-1).mean(-1),
                0.0,
            )
            for c in cat_cols
        }  # each (B, S)
        conf_all = torch.cat([confidence[c.name] for c in cat_cols], -1)
        conf_sorted = torch.sort(conf_all, -1, descending=True).values
        idx = num_update.clamp(0, conf_all.shape[-1] - 1).long()
        threshold = conf_sorted.gather(-1, idx[:, None])  # (B, 1)
        if rounds is not None:
            rounds.append({"confidence": confidence,
                           "threshold": threshold[:, 0]})
        for c in cat_cols:
            name = c.name
            pred = outputs[name].argmax(-1).to(filtered[name].dtype)
            update = (confidence[name] >= threshold) & (confidence[name] > 0)
            filtered[name] = torch.where(update[:, :, None], pred,
                                         filtered[name])
            masks[name] = masks[name] & ~update
            if i > 0:
                final_outputs[name] = torch.where(
                    update[:, :, None, None], outputs[name],
                    final_outputs[name])
        for c in schema.modeled:
            if c.is_sequence:
                modified[c.name] = apply_token(filtered[c.name], c,
                                               masks[c.name], "masked")
    for c in schema.modeled:
        if c.is_sequence and not c.is_categorical:
            final_outputs[c.name] = outputs[c.name]
    return final_outputs
