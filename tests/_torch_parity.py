"""Shared helpers of the PyTorch-port parity tests: one numpy batch, masks
and weights handed to both packages, and the CUDA kernels' tensor-core
arithmetic emulated on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import traverse_util

from flexdm_tpu.data import split_device_batch
from flexdm_tpu.models.masking import get_seq_mask


def numpy_batch(spec, n=4):
    """The first ``n`` test documents as a dict of numpy arrays."""
    batch = next(iter(spec.make_dataset("test", batch_size=n)))
    return {k: np.asarray(v) for k, v in split_device_batch(batch).items()}


def random_masks(schema, batch, seed=0, p=0.4):
    """Per sequence column, a random subset of the valid elements; canvas
    columns all-True."""
    rng = np.random.default_rng(seed)
    seq_mask = np.asarray(get_seq_mask(jnp.asarray(batch["length"]),
                                       schema.max_length))
    b = seq_mask.shape[0]
    return {
        c.name: (seq_mask & (rng.random(seq_mask.shape) < p))
        if c.is_sequence else np.ones(b, bool)
        for c in schema.modeled
    }


def to_jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def to_torch(tree, device="cpu"):
    return {k: torch.from_numpy(np.array(v)).to(device)
            for k, v in tree.items()}


def to_numpy(tree):
    return {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in tree.items()}


def flat_params(variables):
    """Flax variables -> ``{"params/a/b/kernel": numpy array}``."""
    flat = traverse_util.flatten_dict(jax.device_get(variables), sep="/")
    return {k: np.asarray(v) for k, v in flat.items()}


def assert_trees_close(got, want, rtol, atol):
    for name in sorted(want):
        np.testing.assert_allclose(
            np.asarray(got[name]), np.asarray(want[name]),
            rtol=rtol, atol=atol, err_msg=name,
        )


def model_pair(schema, sample, latent_dim=32, num_blocks=2, num_heads=4,
               seed=0, **kwargs):
    """A JAX ``MFPModel`` with its initialised parameters, and the port's
    model (eval mode) with the same weights; ``kwargs`` go to both."""
    from flexdm_tpu.models import mfp as jax_mfp
    from flexdm_tpu.train.trainer import init_params
    from flexdm_tpu_torch.convert import load_jax_params
    from flexdm_tpu_torch.models import mfp as port_mfp

    sizes = dict(latent_dim=latent_dim, num_blocks=num_blocks,
                 num_heads=num_heads)
    jax_model = jax_mfp.MFPModel(schema, attention_impl="xla", **sizes,
                                 **kwargs)
    params = jax.jit(lambda: init_params(jax_model, sample, seed=seed))()
    port_model = port_mfp.MFPModel(schema, **sizes, **kwargs).eval()
    load_jax_params(port_model, flat_params(params))
    return jax_model, params, port_model


def tf32(x):
    """Round float32 to TF32: to nearest, ties away from zero, on the low
    13 bits of the float32 word (``cvt.rna.tf32.f32``)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_matmul(a, b, split):
    """``a @ b`` as the attention kernels' tensor-core products compute it:
    TF32 operands, float32 sums.  ``split``: each operand is hi + lo with
    hi = tf32(x), lo = tf32(x - hi), and a b = lo hi' + hi lo' + hi hi'."""
    ah, bh = tf32(a), tf32(b)
    if not split:
        return ah @ bh
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def assert_partition_specs_match_jax(args, spec, data_dir, model_size):
    """Every parameter of the model a preset's ``args`` build, at its
    published widths: the port's ``partition_spec`` of its torch name and
    shape is JAX's spec of the flax leaf (reversed for a Dense kernel,
    which the port stores transposed).  Returns the names of the split
    parameters."""
    from flexdm_tpu.parallel import mesh as jax_mesh
    from flexdm_tpu.train import trainer as jax_trainer
    from flexdm_tpu_torch.config import TrainConfig, build_model
    from flexdm_tpu_torch.data import DatasetSpec
    from flexdm_tpu_torch.parallel import mesh

    jax_config = jax_trainer.TrainConfig(**{
        k: v for k, v in args.items()
        if k in jax_trainer.TrainConfig.__dataclass_fields__})
    jax_model = jax_trainer.build_model(jax_config, spec.schema)
    sample = split_device_batch(next(iter(spec.make_dataset(
        "train", batch_size=2))))
    shapes = jax_trainer.init_params(jax_model, sample, 0, abstract=True)
    port_model = build_model(TrainConfig.from_args(args), DatasetSpec(
        args["dataset_name"], data_dir).schema)
    port_shapes = {n: tuple(p.shape) for n, p in
                   port_model.named_parameters()}
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    assert len(leaves) == len(port_shapes)
    split = []
    for path, leaf in leaves:
        keys = tuple(getattr(e, "key", None) or getattr(e, "name", None)
                     for e in path)
        want = tuple(jax_mesh.partition_spec(path, leaf.shape, model_size))
        modules, name = list(keys[1:-1]), keys[-1]
        if name == "kernel":
            port_name, want = ".".join(modules + ["weight"]), want[::-1]
        elif name == "scale":
            port_name = ".".join(modules + ["weight"])
        else:
            port_name = ".".join(modules + [name])
        got = mesh.partition_spec(port_name, port_shapes[port_name],
                                  model_size)
        assert got == want, (port_name, got, want)
        if got:
            split.append(port_name)
    return split
