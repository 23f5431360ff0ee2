"""K10d's path choice (parallel/shard.py ``uniform_topk_ctas``): shards
of one card, at most a cluster's 8 of them, take one launch of K2's
cluster kernel with 8 // W CTAs a shard (the value the wrapper hands
the kernel: a cluster of that many times W CTAs); shards on distinct
cards, or more than 8, take the per-shard launches. A plain function
of the shards' devices, so it is held here on the CPU; the kernels it
picks are held on the card (tests/test_torch_cuda.py)."""

from __future__ import annotations

import pytest
import torch

from nomad_tpu_torch.ops.binpack import TOPK_CLUSTER
from nomad_tpu_torch.parallel.shard import uniform_topk_ctas


def cards(*indices):
    return [torch.device("cuda", i) for i in indices]


@pytest.mark.parametrize("w,ctas", [(1, 8), (2, 4), (3, 2), (4, 2), (5, 1),
                                    (7, 1), (8, 1)])
def test_shards_of_one_card_split_one_cluster(w, ctas):
    assert uniform_topk_ctas(cards(*[0] * w)) == ctas
    assert ctas * w <= TOPK_CLUSTER


@pytest.mark.parametrize("w", [9, 16])
def test_more_shards_than_a_cluster_take_the_per_shard_path(w):
    assert uniform_topk_ctas(cards(*[0] * w)) == 0


@pytest.mark.parametrize("indices", [(0, 1), (0, 1, 2, 3), (0, 0, 1, 1),
                                     (1, 1, 1, 0)])
def test_distinct_cards_take_the_per_shard_path(indices):
    assert uniform_topk_ctas(cards(*indices)) == 0


def test_the_choice_reads_the_devices_once():
    """A generator of devices (as the wrapper passes them) is read as a
    list: W counts every shard."""
    assert uniform_topk_ctas(d for d in cards(0, 0, 0, 0)) == 2
    assert uniform_topk_ctas(iter(cards(*[1] * 8))) == 1
