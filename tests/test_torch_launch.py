"""``parallel.sharded.launch`` keeps concurrent launches apart: two small
gloo groups started at once from two threads each form their own group,
even with the rendezvous port that the launch used to pick forced to one
value for both (``_free_port``), and a rank that finds another token in
its group raises."""
import threading

import pytest

from torch_port_util import foreign_token_worker, group_probe

from fv3net_torch.parallel import sharded

HOLD_S = 2.0  # each group held open, so that the two launches overlap


def test_concurrent_launches_keep_their_own_groups(monkeypatch):
    """Two launches of 2 ranks at once, from two threads, each group
    held open ``HOLD_S``: each returns its two ranks in order, and each of them saw a group of 2 made of its
    own launch's processes.  ``_free_port`` returns one port to both (a
    launch that meets through a TCP port picked in the parent then puts
    both groups' ranks on one store)."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    monkeypatch.setattr(sharded, "_free_port", lambda: port, raising=False)
    got, errors = {}, {}

    def run(tag):
        try:
            got[tag] = sharded.launch(group_probe, 2, (tag, HOLD_S))
        except Exception as e:  # noqa: BLE001 - reported below
            errors[tag] = e

    threads = [threading.Thread(target=run, args=(t,)) for t in "AB"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads), "a launch hung"
    assert not errors, errors
    pids = {}
    for tag in "AB":
        results = got[tag]
        assert [r["rank"] for r in results] == [0, 1]
        for r in results:
            assert r["world"] == 2
            assert [m[0] for m in r["members"]] == [tag, tag], (tag, r)
        pids[tag] = {m[1] for m in results[0]["members"]}
        assert all({m[1] for m in r["members"]} == pids[tag]
                   for r in results)
    assert not pids["A"] & pids["B"]


def test_a_rank_outside_its_own_group_raises():
    """Every rank gathers the group's tokens; one that is not its own
    fails the launch."""
    with pytest.raises(Exception, match="not in its own group"):
        sharded.launch(foreign_token_worker, 2)
