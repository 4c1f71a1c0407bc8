"""The statistic that holds a bf16 encode of the port against the JAX
package's, on the CPU.

The port and JAX round to bf16 at different places (bias before or after
the product's rounding, the attention's P, GELU's form), so the port's
bf16 encode cannot equal JAX's bit for bit; it is held by how far each
sits from the JAX fp32 encode of the same weights and inputs, over many
rows (:func:`bf16_rows_close`):

* noise: the root mean square of the port's error over every entry within
  [0.75, 1.25]× JAX's own bf16 error (two-sided: an encode in a finer type
  than bf16 is a defect too);
* bias: the root mean square over the columns of each column's mean error
  at most 2× JAX's.

Measured over 8 ``create_model`` seeds of ``tiny-test`` × both towers at
256 rows, with every bias drawn at N(0, 0.05²)
(:func:`main`, this file run as a script): noise 0.852-1.046, bias
0.407-1.351; the port's bf16 encode is as noisy as JAX's and not biased
beyond the rounding both share.  The former statistic, the largest error over the rows against
1.25× JAX's largest, read 0.62-1.49 on the same runs: a maximum over
few rows is noise, and it failed one seed in 16.  Planted defects read
noise 2.1-4.6 and bias 4.1-16.7 (the last text block's MLP output bias
dropped) and noise 0.10-0.14 (fp16 in place of bf16); the former
statistic misses fp16 (0.08-0.19, under 1.25) and missed the dropped
bias on some weights.  The tests below show both defects failing.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sparsify_clip_tpu.checkpoints import fill_from_flat
from sparsify_clip_tpu.models import clip as jax_clip
from sparsify_clip_tpu_torch.checkpoints import collect_host_arrays, load_jax_params
from sparsify_clip_tpu_torch.models import clip as port_clip

from test_torch_port_models import jax_model
from test_torch_port_resnet import _bf16_close

MIN_ROWS = 256
NOISE_BAND = (0.75, 1.25)
BIAS_MAX = 2.0
MODEL = "tiny-test"
SEEDS = (0, 1, 2, 3)


def bf16_statistic(got, want_bf16, want_fp32):
    """(noise, bias) of the port's bf16 output ``got`` (rows, columns)
    against JAX's bf16 output, both measured from the JAX fp32 output."""
    e_port, e_jax = got - want_fp32, want_bf16 - want_fp32
    noise = np.sqrt((e_port ** 2).mean() / (e_jax ** 2).mean())
    bias = np.sqrt((e_port.mean(0) ** 2).mean() / (e_jax.mean(0) ** 2).mean())
    return float(noise), float(bias)


def bf16_rows_close(got, want_bf16, want_fp32, what=""):
    got, want_bf16, want_fp32 = (np.asarray(a, np.float64).reshape(-1, a.shape[-1])
                                 for a in (got, want_bf16, want_fp32))
    assert got.shape[0] >= MIN_ROWS, f"{what}: {got.shape[0]} rows, the statistic needs {MIN_ROWS}"
    noise, bias = bf16_statistic(got, want_bf16, want_fp32)
    assert NOISE_BAND[0] <= noise <= NOISE_BAND[1], (what, "noise", noise)
    assert bias <= BIAS_MAX, (what, "bias", bias)


def caption_rows(n, context, vocab, seed):
    """SOT, random ids, EOT at a random place, zero padding after it."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(1, vocab - 2, size=(n, context)).astype(np.int32)
    rows[:, 0] = vocab - 2
    eot = rng.integers(2, context, n)
    rows[np.arange(n), eot] = vocab - 1
    rows[np.arange(context)[None] > eot[:, None]] = 0
    return rows


@pytest.fixture(scope="module")
def jax_text():
    model, variables = jax_model(MODEL)
    encode = {dt: jax.jit(lambda p, x, m=model.clone(dtype=dt): m.apply(
        {"params": p}, x, method=jax_clip.CLIP.encode_text)) for dt in (jnp.float32, jnp.bfloat16)}
    cfg = model.cfg
    return variables["params"], encode, caption_rows(MIN_ROWS, cfg.context_length,
                                                     cfg.vocab_size, seed=11)


def _weights(seed):
    """``create_model``'s weights at ``seed`` with every bias drawn too
    (its biases start at 0, where a dropped bias changes nothing)."""
    model = port_clip.create_model(MODEL, device="cpu", seed=seed)
    gen = torch.Generator().manual_seed(100 + seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias") and "ln_" not in name:
                p.copy_(0.05 * torch.randn(p.shape, generator=gen))
    return collect_host_arrays(model)


def _encodes(jax_text, seed, dtype=torch.bfloat16, defect=None):
    params, encode, tokens = jax_text
    flat = _weights(seed)
    jparams = fill_from_flat(params, flat)
    want32 = np.asarray(encode[jnp.float32](jparams, tokens))
    want16 = np.asarray(encode[jnp.bfloat16](jparams, tokens))
    model = load_jax_params(port_clip.create_model(MODEL, device="cpu", dtype=dtype), flat)
    if defect == "dropped-bias":
        with torch.no_grad():
            model.text.transformer.resblocks[-1].mlp.c_proj.bias.zero_()
    with torch.no_grad():
        got = model.encode_text(torch.from_numpy(tokens)).float().numpy()
    return got, want16, want32


@pytest.mark.parametrize("seed", SEEDS)
def test_bf16_text_encode_is_noise_not_bias(jax_text, seed):
    got, want16, want32 = _encodes(jax_text, seed)
    noise, bias = bf16_statistic(got, want16, want32)
    assert 0.8 <= noise <= 1.1 and bias <= 1.5, (noise, bias)  # the measured ranges, above
    bf16_rows_close(got, want16, want32, f"seed {seed}")


@pytest.mark.parametrize("defect", ["dropped-bias", "fp16"])
def test_planted_defects_fail_the_statistic(jax_text, defect):
    dtype = torch.float16 if defect == "fp16" else torch.bfloat16
    got, want16, want32 = _encodes(jax_text, 0, dtype,
                                   defect if defect == "dropped-bias" else None)
    with pytest.raises(AssertionError):
        bf16_rows_close(got, want16, want32, defect)
    # not looser than the former check: what it caught, this catches
    try:
        _bf16_close(got, want16, want32, defect)
        former_caught = False
    except AssertionError:
        former_caught = True
    assert former_caught == (defect == "dropped-bias")


def test_the_statistic_needs_its_rows(jax_text):
    got, want16, want32 = _encodes(jax_text, 0)
    with pytest.raises(AssertionError, match="needs 256"):
        bf16_rows_close(got[:255], want16[:255], want32[:255])


def main() -> None:
    """The measurement behind the ranges in this module's docstring:

        PYTHONPATH=. python3 tests/test_torch_port_bf16.py [--seeds 8] [--rows 256]

    For each seed and tower the same weights and ``--rows`` inputs go
    through the JAX encode in fp32 and in bf16 and through the port's
    encode in bf16, in fp16 and (the text tower) in bf16 with the last
    text block's MLP output bias dropped; one JSON line each with
    ``noise``, ``bias`` and ``former`` (the largest error against JAX's
    largest, which ``_bf16_close`` holds to 1.25), then each one's range
    by variant.  CPU only."""
    import argparse
    import json

    from test_torch_port_models import images

    parser = argparse.ArgumentParser()
    parser.add_argument("--seeds", type=int, default=8)
    parser.add_argument("--rows", type=int, default=256)
    args = parser.parse_args()
    jax.config.update("jax_platforms", "cpu")

    model, variables = jax_model(MODEL)
    cfg = model.cfg
    inputs = {"text": caption_rows(args.rows, cfg.context_length, cfg.vocab_size, seed=11),
              "image": images(args.rows, cfg.image_size, seed=12)}
    methods = {"text": jax_clip.CLIP.encode_text, "image": jax_clip.CLIP.encode_image}
    encode = {(tower, dt): jax.jit(lambda p, x, m=model.clone(dtype=dt), f=methods[tower]:
                                   m.apply({"params": p}, x, method=f))
              for tower in inputs for dt in (jnp.float32, jnp.bfloat16)}
    ranges = {}
    for seed in range(args.seeds):
        flat = _weights(seed)
        params = fill_from_flat(variables["params"], flat)
        variants = {}
        for name, dtype in (("bf16", torch.bfloat16), ("fp16", torch.float16),
                            ("dropped-bias", torch.bfloat16)):
            port = load_jax_params(port_clip.create_model(MODEL, device="cpu", dtype=dtype), flat)
            if name == "dropped-bias":
                with torch.no_grad():
                    port.text.transformer.resblocks[-1].mlp.c_proj.bias.zero_()
            variants[name] = port
        for tower, x in inputs.items():
            want32 = np.asarray(encode[tower, jnp.float32](params, x), np.float64)
            want16 = np.asarray(encode[tower, jnp.bfloat16](params, x), np.float64)
            for name, port in variants.items():
                if name == "dropped-bias" and tower != "text":
                    continue  # the dropped bias is the text tower's
                with torch.no_grad():
                    fn = port.encode_text if tower == "text" else port.encode_image
                    got = fn(torch.from_numpy(x)).float().numpy().astype(np.float64)
                noise, bias = bf16_statistic(got, want16, want32)
                former = float(np.abs(got - want32).max() / np.abs(want16 - want32).max())
                row = dict(seed=seed, tower=tower, variant=name, noise=noise, bias=bias,
                           former=former)
                print(json.dumps(row), flush=True)
                for key in ("noise", "bias", "former"):
                    lo, hi = ranges.get((name, key), (np.inf, -np.inf))
                    ranges[name, key] = (min(lo, row[key]), max(hi, row[key]))
    print(json.dumps({f"{name}/{key}": [round(lo, 3), round(hi, 3)]
                      for (name, key), (lo, hi) in sorted(ranges.items())}))


if __name__ == "__main__":
    main()
