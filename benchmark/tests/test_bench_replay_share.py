"""``replay_share.fit`` on hand-made profiler events: the share of the
traced fits' iterations that replay graphs captured before them."""

from types import SimpleNamespace as E

import pytest
import torch

from benchmark import run, trace

CPU = torch.autograd.DeviceType.CPU


def ev(name, start, end, thread=1):
    return E(name=name, device_type=CPU, time_range=E(start=start, end=end),
             thread=thread, id=0, linked_correlation_id=0,
             is_user_annotation=False)


def fit(at, iterations):
    """One fit from ``at`` (us) with one iteration a 10 us slot; each
    iteration is given by the names of the spans it holds."""
    events = [ev(trace.CALL, at, at + 100), ev("iht.fit", at + 1, at + 99),
              ev("iht.solve", at + 2, at + 98)]
    for i, inner in enumerate(iterations):
        s = at + 5 + 10 * i
        events.append(ev("iht.iteration", s, s + 9))
        for j, name in enumerate(inner):
            events.append(ev(name, s + 1 + 2 * j, s + 2 + 2 * j))
    return events


READ = run.metric_reader("replay_share.fit")


def test_share_of_replayed_iterations():
    # the first fit captures in its first iteration; the second replays
    # in all three, backtracks included
    events = (fit(0, [["iht.capture", "iht.replay", "iht.replay"],
                      ["iht.replay", "iht.sync", "iht.replay"],
                      ["iht.replay", "iht.replay", "iht.replay"]])
              + fit(200, [["iht.replay"], ["iht.replay"], ["iht.replay"]])
              + [ev("iht.iteration", 10, 30, thread=2)])   # another thread
    assert READ(dict(kind="fit", events=events)) == pytest.approx(5 / 6)


def test_eager_iterations_count_against_the_share():
    events = fit(0, [["iht.replay"], ["iht.stepsize"], ["iht.replay"],
                     ["iht.sync"]])
    assert READ(dict(kind="fit", events=events)) == pytest.approx(0.5)


@pytest.mark.parametrize("kind,inner", [("cv", ["iht.replay"]),
                                        ("fit", ["iht.stepsize"])],
                         ids=["cv", "no_replay_span"])
def test_none_without_replayed_fits(kind, inner):
    """A cv, and a program that opens no ``iht.replay`` span (the parent
    of the replayed loop), give None and no error."""
    top = fit(0, [inner, inner])
    assert READ(dict(kind=kind, events=top)) is None
