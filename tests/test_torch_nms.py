"""The port's NMS against the JAX package's, with the same inputs to both.

Suppression must agree bit for bit. The selection stages are fed the same
head outputs on both sides, so the detections are compared exactly: any
difference is a selection difference, not a conv-numerics one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import efficientdet_tpu.ops.nms as jn
from efficientdet_tpu.anchors import iou_matrix as j_iou
from efficientdet_tpu.anchors import anchors_for_shape
from efficientdet_tpu.configs import EvalConfig as JEvalConfig
from efficientdet_tpu.ops.nms_pallas import suppression_keep_mask as j_keep_mask
import efficientdet_tpu_torch.ops.nms as tn
from efficientdet_tpu_torch.configs import EvalConfig
from efficientdet_tpu_torch.anchors import iou_matrix as t_iou
from efficientdet_tpu_torch.ops.nms_kernel import (
    MAX_CANDIDATES,
    smem_bytes,
    suppression_keep_mask,
    suppression_keep_mask_reference,
)


def _candidates(seed, b, k, classes, spread=200.0):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, spread, (b, k, 2))
    wh = rng.uniform(10, 120, (b, k, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes[:, 1::7] = boxes[:, 0::7][:, : boxes[:, 1::7].shape[1]]  # exact duplicates
    cls = rng.randint(0, classes, (b, k)).astype(np.int32)
    valid = rng.rand(b, k) > 0.1
    return boxes, cls, valid


def _xla_fixpoint(boxes, cls, valid, thr):
    def one(bx, cl, va):
        k = bx.shape[0]
        tri = jnp.arange(k)[:, None] < jnp.arange(k)[None, :]
        sup = (j_iou(bx, bx) > thr) & (cl[:, None] == cl[None, :]) & tri
        return jn._fixpoint_suppress(sup, va)
    return np.asarray(jax.vmap(one)(jnp.asarray(boxes), jnp.asarray(cls), jnp.asarray(valid)))


@pytest.mark.parametrize("seed,k,classes,thr", [
    (0, 256, 4, 0.5), (1, 200, 3, 0.5), (2, 300, 1, 0.3), (3, 129, 16, 0.5), (4, 512, 2, 0.7),
])
def test_suppression_bit_for_bit(seed, k, classes, thr):
    boxes, cls, valid = _candidates(seed, 3, k, classes)
    got = suppression_keep_mask_reference(
        torch.from_numpy(boxes), torch.from_numpy(cls), torch.from_numpy(valid), thr
    ).numpy()
    np.testing.assert_array_equal(got, _xla_fixpoint(boxes, cls, valid, thr))
    pallas = np.asarray(j_keep_mask(jnp.asarray(boxes), jnp.asarray(cls), jnp.asarray(valid), thr, interpret=True))
    np.testing.assert_array_equal(got, pallas)
    assert 0 < got.sum() < valid.sum()  # suppression did something
    # the wrapper on CPU tensors is the plain version, with no launch
    before = suppression_keep_mask.launches
    again = suppression_keep_mask(
        torch.from_numpy(boxes), torch.from_numpy(cls), torch.from_numpy(valid), thr
    )
    assert suppression_keep_mask.launches == before
    np.testing.assert_array_equal(again.numpy(), got)


def test_suppression_bench_data():
    # the data the JAX package's kernel-parity check uses: B=4, K=1024, 16 classes
    rng = np.random.RandomState(0)
    xy = rng.uniform(0, 400, (4, 1024, 2))
    wh = rng.uniform(10, 150, (4, 1024, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    cls = rng.randint(0, 16, (4, 1024)).astype(np.int32)
    valid = rng.rand(4, 1024) > 0.1
    got = suppression_keep_mask_reference(
        torch.from_numpy(boxes), torch.from_numpy(cls), torch.from_numpy(valid)
    ).numpy()
    np.testing.assert_array_equal(got, _xla_fixpoint(boxes, cls, valid, 0.5))


def _bucket(c):
    """The kernel's class bucket of class ``c``: the top 7 bits of
    ``c * 2654435761`` taken modulo 2**32."""
    return ((int(c) * 2654435761) & 0xFFFFFFFF) >> 25


def _packed_mask(boxes, cls, thr, rng):
    """One image's suppression matrix bit-packed as the CUDA kernel builds it:
    (K, W) 64-bit words, bit c of word w in row j meaning "j suppresses
    64w + c". A row's candidates in word w are its class bucket's bits there,
    less the other classes of the bucket; only the words at or right of j's
    own word are built, and the others hold random bits here, which the scan
    must never read."""
    k = boxes.shape[0]
    w = -(-k // 64)
    b = torch.from_numpy(boxes)
    above = (t_iou(b, b) > np.float32(thr)).numpy()
    buckets = [[0] * 128 for _ in range(w)]
    for i in range(k):
        buckets[i // 64][_bucket(cls[i])] |= 1 << (i % 64)
    mask = [[int(v) for v in row] for row in rng.randint(0, 2 ** 63, (k, w), dtype=np.int64)]
    for j in range(k):
        for ww in range(j // 64, w):
            m = buckets[ww][_bucket(cls[j])]
            if ww == j // 64:
                m &= ~((2 << (j % 64)) - 1)  # only i > j
            bits = 0
            while m:
                c = (m & -m).bit_length() - 1
                m &= m - 1
                i = 64 * ww + c
                if cls[i] == cls[j] and above[j, i]:
                    bits |= 1 << c
            mask[j][ww] = bits
    return mask


def _word_scan(mask, valid):
    """The kernel's word-blocked greedy scan, one image, in Python integers.

    Lane l of the scan warp holds word l of the removed set. For each word w
    in order: the diagonal block transposed (col[l] bit c: 64w + c
    suppresses 64w + l); the word's kept set iterated from its available
    candidates, kept = avail & ~{l : col[l] & kept}, until a step changes
    nothing; then every lane l > w ORs in mask[i][l] of each kept i of word
    w (the fan-in)."""
    k, n_words = len(mask), len(mask[0])
    vbits = [sum(int(v) << c for c, v in enumerate(valid[64 * w:64 * w + 64])) for w in range(n_words)]
    removed = [0] * n_words
    keep = np.zeros(k, bool)
    for w in range(n_words):
        base, n = 64 * w, min(64, k - 64 * w)
        col = [sum(((mask[base + c][w] >> lane) & 1) << c for c in range(n)) for lane in range(64)]
        avail = vbits[w] & ~removed[w]
        kept = avail
        while True:
            hit = sum(1 << lane for lane in range(64) if col[lane] & kept)
            nxt = avail & ~hit
            if nxt == kept:
                break
            kept = nxt
        for lane in range(w + 1, n_words):
            m, acc = kept, 0
            while m:
                c = (m & -m).bit_length() - 1
                m &= m - 1
                acc |= mask[base + c][lane]
            removed[lane] |= acc
        keep[base:base + n] = [(kept >> c) & 1 for c in range(n)]
    return keep


@pytest.mark.parametrize("seed,k,classes,thr,spread,all_invalid", [
    (0, 256, 4, 0.5, 200.0, False),   # the parity seeds above
    (1, 200, 3, 0.5, 200.0, False),
    (2, 300, 1, 0.3, 200.0, False),
    (3, 129, 16, 0.5, 200.0, False),
    (4, 512, 2, 0.7, 200.0, False),
    (5, 1000, 16, 0.5, 400.0, False),  # K not a multiple of 64
    (6, 40, 3, 0.5, 60.0, False),      # fewer than one word
    (7, 300, 4, 0.5, 200.0, True),     # nothing valid
    (8, 512, 2, 0.5, 60.0, False),     # two classes, dense
    (9, 600, 300, 0.5, 40.0, False),   # more classes than buckets: a bucket's others dropped
])
def test_word_blocked_scan_matches_the_fixpoint(seed, k, classes, thr, spread, all_invalid):
    boxes, cls, valid = _candidates(seed, 2, k, classes, spread)
    if all_invalid:
        valid[:] = False
    rng = np.random.RandomState(seed)
    got = np.stack([_word_scan(_packed_mask(boxes[i], cls[i], thr, rng), valid[i]) for i in range(2)])
    want = suppression_keep_mask_reference(
        torch.from_numpy(boxes), torch.from_numpy(cls), torch.from_numpy(valid), thr
    ).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _xla_fixpoint(boxes, cls, valid, thr))
    if all_invalid:
        assert not got.any()
    else:
        assert 0 < got.sum() < valid.sum()


def test_suppression_kernel_fits_the_default_candidates():
    # one image per block in at most 232,448 B of shared memory
    assert smem_bytes(1024) == 188_544
    assert EvalConfig().pre_nms_top_k <= MAX_CANDIDATES == 1152
    assert smem_bytes(MAX_CANDIDATES) <= 232_448 < smem_bytes(MAX_CANDIDATES + 1)


HWS = (256, 64, 16, 4, 1)  # pixels per level at 128 px
A = 9


def _head_outputs(seed, b, c):
    """Anchor-major head outputs and the same values in concat layout."""
    rng = np.random.RandomState(seed)
    total = A * sum(HWS)
    cls = rng.normal(-3.0, 2.0, (b, total, c)).astype(np.float32)
    box = rng.normal(0.0, 0.5, (b, total, 4)).astype(np.float32)
    m = b * sum(HWS)
    z = np.zeros((A, m, c), np.float32)
    zb = np.zeros((m, A * 4), np.float32)
    amax = []
    off = row = 0
    for hw in HWS:
        lc = cls[:, off:off + hw * A].reshape(b, hw, A, c)
        lb = box[:, off:off + hw * A].reshape(b, hw, A, 4)
        z[:, row:row + b * hw] = lc.transpose(2, 0, 1, 3).reshape(A, b * hw, c)
        zb[row:row + b * hw] = lb.reshape(b * hw, A * 4)
        amax.append(lc.max(-1).transpose(0, 2, 1).reshape(b, A * hw))
        off += hw * A
        row += b * hw
    return (z, np.concatenate(amax, 1), HWS), (zb, HWS), cls, box


CONFIGS = [
    dict(),                                              # the default EvalConfig
    dict(per_anchor_top_c=3),                            # the class cap at work
    dict(score_threshold=0.3, pre_nms_top_k=300),        # many below threshold, K % 128 != 0
    dict(nms_iou_threshold=0.3, max_detections=20),
]


def _assert_same(got, want):
    """Boxes, classes and counts exactly; scores to two float32 ulps.

    The scores are sigmoids of equal logits, but ATen's and XLA's float32
    logistic differ by one or two ulps for about 0.7% of inputs
    (test_logistic_agrees_to_two_ulps).
    """
    names = ("boxes", "scores", "classes", "num_valid")
    for name, g, w in zip(names, got, want):
        if name == "scores":
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2.0 ** -22, atol=0)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("cfg", range(len(CONFIGS)))
@pytest.mark.parametrize("c", [6, 20])
def test_anchor_major_selection_matches_jax(cfg, c):
    kw = CONFIGS[cfg]
    cls_out, box_out, _, _ = _head_outputs(cfg * 10 + c, 2, c)
    anchors = anchors_for_shape((128, 128))
    jc = jn.anchor_major_candidates(
        jnp.asarray(anchors), (jnp.asarray(box_out[0]), HWS),
        (jnp.asarray(cls_out[0]), jnp.asarray(cls_out[1]), HWS), (128, 128), JEvalConfig(**kw),
    )
    want = jn._pairs_and_suppress(*jc, JEvalConfig(**kw), use_pallas=False)
    tc = tn.anchor_major_candidates(
        torch.from_numpy(anchors), (torch.from_numpy(box_out[0]), HWS),
        (torch.from_numpy(cls_out[0]), torch.from_numpy(cls_out[1]), HWS), (128, 128), EvalConfig(**kw),
    )
    np.testing.assert_array_equal(tc[0].numpy(), np.asarray(jc[0]))
    np.testing.assert_array_equal(tc[1].numpy(), np.asarray(jc[1]))
    got = tn._pairs_and_suppress(*tc, EvalConfig(**kw))
    _assert_same(got, want)
    assert 0 < int(got[3].min())


@pytest.mark.parametrize("cfg", range(len(CONFIGS)))
def test_front_ends_agree(cfg):
    kw = CONFIGS[cfg]
    cls_out, box_out, cls, box = _head_outputs(cfg + 100, 2, 8)
    anchors = torch.from_numpy(anchors_for_shape((128, 128)))
    am = tn.batched_filter_from_anchor_major_levels(
        anchors, (torch.from_numpy(box_out[0]), HWS),
        (torch.from_numpy(cls_out[0]), torch.from_numpy(cls_out[1]), HWS), (128, 128), EvalConfig(**kw),
    )
    cc = tn.batched_filter_from_logits(
        anchors, torch.from_numpy(box), torch.from_numpy(cls), (128, 128), EvalConfig(**kw)
    )
    for g, w in zip(am, cc):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    want = jn.batched_filter_from_logits(
        jnp.asarray(anchors.numpy()), jnp.asarray(box), jnp.asarray(cls), (128, 128),
        JEvalConfig(**kw), use_pallas=False,
    )
    _assert_same(cc, want)


def test_logistic_agrees_to_two_ulps():
    """The scores' tolerance above: ATen's and XLA's float32 logistic.

    On 200,000 normal logits the two differ for about 0.7% of inputs, by
    one float32 ulp or, for about 0.05%, two.
    """
    x = np.random.RandomState(0).normal(-3, 2, 200_000).astype(np.float32)
    want = np.asarray(jax.nn.sigmoid(jnp.asarray(x)))
    got = torch.sigmoid(torch.from_numpy(x)).numpy()
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 2
    assert (ulps > 0).mean() < 0.02
