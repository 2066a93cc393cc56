"""The traffic generator: one seed repeats exactly; every seed does the
same work in another order."""

from __future__ import annotations

import collections

import torch

from benchmark.harness import traffic
from benchmark.harness.spec import cell, load_bench

BIG = 2**31 + 987_654_321


def _mix(name: str) -> dict:
    return cell(name, load_bench())["traffic"]


def _take(it, n):
    return [next(it) for _ in range(n)]


def test_train_traffic_repeats_exactly_from_one_seed():
    mix = _mix("train-exp1")
    a = _take(traffic.train_steps(mix, BIG, (8, 8, 4), "cpu"), 6)
    b = _take(traffic.train_steps(mix, BIG, (8, 8, 4), "cpu"), 6)
    for x, y in zip(a, b):
        assert x["n_steps"] == y["n_steps"] and x["prompt"] == y["prompt"]
        assert torch.equal(x["cond_ids"], y["cond_ids"]) and torch.equal(x["noises"], y["noises"])
    assert not torch.equal(a[1]["noises"], a[2]["noises"])  # every step's lanes differ
    assert a[0]["noises"].shape == (mix["lanes"], 8, 8, 4)


def test_train_window_work_is_the_same_on_every_seed():
    mix = _mix("train-exp1")
    low, high = mix["denoising_steps"]
    for seed in (0, 1, BIG, 2**40 + 3):
        counts = traffic.train_step_counts(mix, seed, 37)
        assert low <= counts[0] <= high
        window = counts[1:]
        assert all(sum(window[i:i + 3]) == 3 * (low + high) // 2 for i in range(0, 36, 3))
        assert set(window) == set(range(low, high + 1))
    orders = {tuple(traffic.train_step_counts(mix, s, 9)[1:]) for s in range(8)}
    assert len(orders) > 1


def test_gen_traffic_is_the_protocol_in_a_seeded_order():
    mix = _mix("gen-unet-lora")
    a, b = _take(traffic.gen_batches(mix, BIG), 12), _take(traffic.gen_batches(mix, BIG), 12)
    assert [x["prompt"] for x in a] == [x["prompt"] for x in b]
    assert all(len(x["images"]) == mix["batch"] for x in a)
    per_prompt = collections.Counter(x["prompt"] for x in a[:6])
    assert list(per_prompt.values()) == [mix["images_per_prompt"] // mix["batch"]]
    assert a[0]["images"] == list(range(10)) and a[5]["images"] == list(range(50, 60))
    other = _take(traffic.gen_batches(mix, BIG + 1), 12)
    assert sorted(x["prompt"] for x in other[:6 * 2]) != [] and len(other) == 12


def test_prompt_ids_pad_as_clip_pads():
    ids = traffic.prompt_ids("a photo of the face of a doctor, a person")
    assert ids.shape == (1, 77)
    assert ids[0, 0] == 49406 and ids[0, 1:12].lt(49406).all() and ids[0, 12:].eq(49407).all()
    assert traffic.uncond_ids()[0, :2].tolist() == [49406, 49407]
    assert torch.equal(traffic.prompt_ids("x y", vocab=64, length=16)[0, -1], torch.tensor(63))
