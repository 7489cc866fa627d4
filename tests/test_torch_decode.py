"""Port vs JAX: greedy and beam-3 decodes are token-exact on tiny-idefics.

Both sides run their own ``bind_images`` forward on the same params and
left-padded prompts (CPU, f32), with the ICV on.  Covers EOS (an id chosen
from JAX's own first run, so a row really finishes), ``min_new_tokens``, and
``length_penalty=0`` (the reference setting) beside a non-zero one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from licv_vqa_tpu.infer.decode import beam_generate as jx_beam
from licv_vqa_tpu.infer.decode import greedy_generate as jx_greedy
from licv_vqa_tpu.models import idefics as jx_idefics
from licv_vqa_tpu_torch.infer.decode import beam_generate as pt_beam
from licv_vqa_tpu_torch.infer.decode import greedy_generate as pt_greedy
from licv_vqa_tpu_torch.models import idefics as pt_idefics
from tests.test_torch_idefics import icv_pair, tiny_inputs, tiny_pair

MAX_NEW = 5
PAD = 0


def _decode(kind, eos, min_new=0, lp=0.0):
    rng = np.random.default_rng(7)
    ids, mask, pixels, valid = tiny_inputs(rng)
    jicv, picv = icv_pair(rng)
    jcfg, jparams, pcfg, pparams = tiny_pair()
    max_len = ids.shape[1] + MAX_NEW + 1
    jf = jx_idefics.make_idefics_forward_fns(jcfg, eos)[1](
        jparams, jnp.asarray(pixels), jnp.asarray(valid), jnp.asarray(ids), jicv, max_len
    )
    pf = pt_idefics.make_idefics_forward_fns(pcfg, eos)[1](
        pparams, torch.from_numpy(pixels), torch.from_numpy(valid),
        torch.from_numpy(ids), picv, max_len,
    )
    if kind == "greedy":
        kw = dict(max_new_tokens=MAX_NEW, eos_token_id=eos, pad_token_id=PAD, min_new_tokens=min_new)
        want = jx_greedy(jf, jnp.asarray(ids), jnp.asarray(mask), **kw)
        got = pt_greedy(pf, torch.from_numpy(ids), torch.from_numpy(mask), **kw)
    else:
        kw = dict(
            max_new_tokens=MAX_NEW, eos_token_id=eos, pad_token_id=PAD, num_beams=3,
            length_penalty=lp, min_new_tokens=min_new,
        )
        want = jx_beam(jf, jnp.asarray(ids), jnp.asarray(mask), **kw)
        got = pt_beam(pf, torch.from_numpy(ids), torch.from_numpy(mask), **kw)
    return np.asarray(want), got.numpy(), ids.shape[1]


@pytest.mark.parametrize("kind", ["greedy", "beam"])
def test_decode_token_exact_with_eos_and_min_new(kind):
    want, got, s = _decode(kind, eos=2)
    np.testing.assert_array_equal(got, want)
    # make a row finish: EOS := the token JAX emitted second on row 0
    eos = int(want[0, s + 1])
    want, got, s = _decode(kind, eos=eos)
    np.testing.assert_array_equal(got, want)
    assert (want[:, s:] == eos).any()
    # min_new_tokens suppresses that EOS for the first steps
    want, got, s = _decode(kind, eos=eos, min_new=3)
    np.testing.assert_array_equal(got, want)
    assert not (want[:, s : s + 3] == eos).any()


def test_beam_nonzero_length_penalty_token_exact():
    want, got, _ = _decode("beam", eos=2, lp=1.0)
    np.testing.assert_array_equal(got, want)


def test_topk_tie_order_is_lower_index_first():
    from licv_vqa_tpu_torch.infer.decode import _topk

    x = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    vals, idx = _topk(x, 3)
    assert idx.tolist() == [[1, 2, 4]] and vals.tolist() == [[3.0, 3.0, 3.0]]
