"""``pack_first_fit`` holds the ids its kernel indexes with to the tables'
bounds on the host, before any kernel or plain version runs: every pod's
open signature in [0, S), every pod's core in [0, C), every join-table
entry below S (negative entries mean "does not join" and stay). The card
would read out of bounds on such a batch; the CPU path raises the same
``ValueError`` before the plain version runs."""

import pytest
import torch

from karpenter_tpu_torch.solver import carry, pack_kernel
from torch_parity import synth_fields

S, C = 6, 4


def cpu_args():
    f = synth_fields(P=64, S=S, F=2, R=3, C=C, n_hosts=3, seed=8)
    return carry.tensors_from_reference(f, "cpu")["pack_args"]


def _with(args, i, idx, value):
    t = args[i].clone()
    t[idx] = value
    return args[:i] + (t,) + args[i + 1:]


@pytest.fixture
def plain_never_runs(monkeypatch):
    def fail(*args, **kw):
        raise AssertionError("the plain version ran on a malformed batch")

    monkeypatch.setattr(pack_kernel, "pack_reference", fail)


@pytest.mark.parametrize(
    "i,idx,value,match",
    [
        (1, 5, S, "open signatures"),  # open signature at S
        (1, 0, -1, "open signatures"),  # negative open signature
        (2, 7, C, "pod cores"),  # core at C
        (2, 3, -1, "pod cores"),  # negative core
        (7, (2, 1), S, "join_table"),  # joined id at S
        (7, (S - 1, C - 1), 1 << 20, "join_table"),  # joined id far past S
    ],
    ids=["open_sig_hi", "open_sig_lo", "core_hi", "core_lo", "joined_id", "joined_id_far"],
)
def test_out_of_range_ids_raise_before_the_plain_version(plain_never_runs, i, idx, value, match):
    with pytest.raises(ValueError, match=match):
        pack_kernel.pack_first_fit(*_with(cpu_args(), i, idx, value), n_max=16)


def test_out_of_range_id_in_one_problem_of_a_batch(plain_never_runs):
    good = cpu_args()
    bad = _with(good, 2, 0, C)
    stacked = tuple(torch.stack(col) for col in zip(good, bad, good))
    with pytest.raises(ValueError, match="pod cores"):
        pack_kernel.pack_first_fit(*stacked, n_max=16)


def test_negative_join_entries_and_edge_ids_pass():
    args = cpu_args()
    join = torch.full((S, C), -7, dtype=torch.int32)
    join[:, 0] = torch.arange(S, dtype=torch.int32)  # ids up to S - 1
    args = args[:7] + (join,) + args[8:]
    args = _with(args, 2, 0, C - 1)
    args = _with(args, 1, 0, S - 1)
    out = pack_kernel.pack_first_fit(*args, n_max=16)
    assert out.assignment.shape == (64,) and int(out.n_nodes) >= 1
