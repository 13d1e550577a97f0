"""The open-loop generator's schedule at fixed seeds, and its wire format
against the daemon's."""

from __future__ import annotations

import asyncio

import numpy as np

from portbench import loadgen


def test_schedule_is_a_fixed_count_of_poisson_arrivals_spanning_the_window():
    times, clips = loadgen.schedule(2**33 + 5, rate=400.0, seconds=10.0, bank=64)
    assert len(times) == 4000 and len(clips) == 4000
    assert times[0] == 0.0 and abs(times[-1] - 10.0) < 0.01
    assert np.all(np.diff(times) >= 0)
    gaps = np.diff(times)
    # exponential gaps: mean 1 / rate, coefficient of variation about 1
    assert abs(gaps.mean() * 400.0 - 1.0) < 0.01
    assert 0.9 < gaps.std() / gaps.mean() < 1.1
    assert clips.min() >= 0 and clips.max() < 64 and len(set(clips.tolist())) == 64


def test_schedule_repeats_for_a_seed_and_differs_between_seeds():
    a = loadgen.schedule(7, 100.0, 5.0, 8)
    b = loadgen.schedule(7, 100.0, 5.0, 8)
    c = loadgen.schedule(8, 100.0, 5.0, 8)
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert not np.array_equal(a[0], c[0])
    assert len(c[0]) == len(a[0])  # every seed offers the same work


def test_frame_is_the_daemons_wire_format():
    from h36x_torch.serve_daemon import _read_msg

    payload = np.arange(6, dtype=np.float32).tobytes()

    async def roundtrip():
        reader = asyncio.StreamReader()
        reader.feed_data(loadgen._frame(payload, (2, 3)))
        reader.feed_eof()
        return await _read_msg(reader)

    header, body = asyncio.run(roundtrip())
    assert header["shape"] == [2, 3] and header["dtype"] == "float32" and body == payload
