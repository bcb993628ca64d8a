"""The plain reference against hand-computed answers at a tiny size, and
the judge's bounds for reads that overlapped writes."""

import json

import pytest
import torch

from gpubench import check, reference


class _Cols:
    """Two blocks of hand-written columns: f a set field (rows 0-2), v an
    int field 0..9."""

    device = torch.device("cpu")
    fields = [{"name": "f", "field": {"type": "set"}},
              {"name": "v", "field": {"type": "int", "min": 0, "max": 9}}]
    F = [[0, 1, 1, 2, 0], [2, 2, 1]]
    V = [[3, 9, 0, 5, 7], [1, 2, 8]]

    def field(self, name):
        return next(f for f in self.fields if f["name"] == name)

    def rows(self, name):
        return [0, 1, 2]

    def iter_blocks(self):
        for i in range(2):
            yield i, 1, len(self.F[i]), {"f": torch.tensor(self.F[i], dtype=torch.int32),
                                         "v": torch.tensor(self.V[i], dtype=torch.int32)}


CALLS = [
    ({"agg": "Count", "field": None, "where": [["f", "row", 2, None]]}, (3, 0)),
    ({"agg": "Count", "field": None, "where": [["f", "row", 1, None], ["v", "<", 5, None]]},
     (1, 0)),
    ({"agg": "Sum", "field": "v", "where": [["f", "row", 2, None]]}, (3, 5 + 1 + 2)),
    ({"agg": "Sum", "field": "v", "where": [["v", "between", 2, 7]]}, (4, 3 + 5 + 7 + 2)),
    ({"agg": "Sum", "field": "v", "where": [["f", "row", 0, None], ["v", "==", 7, None]]},
     (1, 7)),
    ({"agg": "Sum", "field": "v", "where": []}, (8, 35)),
]


def _ref():
    ref = reference.Reference(_Cols(), [reference.group_of(c) for c, _ in CALLS])
    ref.build()
    return ref


@pytest.mark.parametrize("i", range(len(CALLS)))
def test_the_reference_answers_as_counted_by_hand(i):
    call, want = CALLS[i]
    assert _ref().answer(call) == want


def test_a_read_during_writes_lies_between_acknowledged_and_sent():
    ref = _ref()
    rides = [{"values": {"f": 2, "v": 4}}, {"values": {"f": 2, "v": 6}}, {"values": {"f": 0, "v": 1}}]
    # ride 0 acknowledged at 1.0; ride 1 sent at 1.5, acknowledged at 3.0;
    # ride 2 sent at 5.0 and failed.
    writes = [[0, 0.0, 0.5, 1.0, 200, json.dumps({"results": [True]})],
              [1, 1.0, 1.5, 3.0, 200, json.dumps({"results": [True]})],
              [2, 2.0, 5.0, 5.5, 500, "boom"]]
    call = CALLS[0][0]
    requests = [{"template": "t", "calls": [call]}]
    judge = check.Judge(ref, requests, rides, writes)
    assert judge.failed_writes and judge.failed_writes[0][0] == 2

    def read(t_send, t_recv, got):
        rec = [0, 0, t_send, t_recv, 200, json.dumps({"results": [got]})]
        return judge.reads([rec])["wrong_calls"]

    # Sent at 2.0 (ride 0 acknowledged, ride 1 in flight): 4 or 5.
    assert read(2.0, 2.5, 4) == 0 and read(2.0, 2.5, 5) == 0
    assert read(2.0, 2.5, 3) == 1 and read(2.0, 2.5, 6) == 1
    # Sent at 4.0: both acknowledged, exactly 5.
    assert read(4.0, 4.5, 5) == 0 and read(4.0, 4.5, 4) == 1
    # Before any write: exactly the base.
    assert read(0.1, 0.4, 3) == 0 and read(0.1, 0.4, 4) == 1
    back = judge.readback([call, CALLS[5][0]], [5, {"value": 35 + 4 + 6, "count": 10}])
    assert back["readback_wrong"] == 0
    back = judge.readback([call], [6])
    assert back["readback_wrong"] == 1


def test_a_failed_or_short_answer_is_a_failed_read():
    judge = check.Judge(_ref(), [{"template": "t", "calls": [CALLS[0][0], CALLS[2][0]]}], [], [])
    out = judge.reads([[0, 0, 0.0, 1.0, 503, "busy"],
                       [0, 0, 0.0, 1.0, 200, json.dumps({"results": [3]})],
                       [0, 0, 0.0, 1.0, 200, json.dumps({"results": [3, {"value": 8, "count": 3}]})]])
    assert out["failed_reads"] == 2 and out["wrong_calls"] == 0 and out["calls"] == 6
