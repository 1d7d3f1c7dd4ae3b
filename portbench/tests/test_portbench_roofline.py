"""The frozen work counts on a hand case: three pods, one signature, one
core, a frontier of (2, 2). Pods (1, 1) and (1, 1) share node 0; pod
(3, 3) opens node 1."""

import numpy as np
import pytest

import roofline

N_CAP = 4


def v1_case(assignment):
    args = (
        np.ones(3, bool),                       # valid (a mask, as the wrapper takes it)
        np.zeros(3, np.int32),                  # open_sig
        np.zeros(3, np.int32),                  # core
        np.full(3, -1, np.int32),               # host
        np.zeros(3, bool),                      # host in base
        np.full(3, -1, np.int32),               # open_host
        np.array([[1, 1], [1, 1], [3, 3]], np.float32),  # req
        np.array([[0]], np.int32),              # join [S, C]
        np.array([[[2, 2]]], np.float32),       # frontiers [S, F, R]
        np.zeros(2, np.float32),                # daemon
    )
    outputs = (
        np.array(assignment, np.int32),
        np.array([0, 0, -1, -1], np.int32),
        np.full(N_CAP, -1, np.int32),
        np.zeros((N_CAP, 2), np.float32),
        np.array([2], np.int32),
    )
    return args, outputs


def test_v1_work_counts_the_replay_and_the_fresh_node_walks():
    args, outputs = v1_case([0, 0, 1])
    n_bytes, ops = roofline.v1_work(args, outputs[0], outputs)
    # replay: open (2) + [join 1, adds 2, walk 2] + [join 1, adds 2, walk 1] + open (2) = 13;
    # fresh-node walks: 3 pods x 2 adds + compares 2 + 2 + 1 = 11
    assert ops == 24
    assert n_bytes == sum(a.nbytes for a in args) + sum(o.nbytes for o in outputs)


def test_v1_replay_raises_where_the_kernel_did_not_fit_first():
    args, outputs = v1_case([0, 1, 1])
    with pytest.raises(AssertionError, match="pod 1 fits node 0"):
        roofline.v1_work(args, outputs[0], outputs)
    args, outputs = v1_case([0, 0, 3])
    with pytest.raises(AssertionError, match="pod 2 fits no open node"):
        roofline.v1_work(args, outputs[0], outputs)


def v2_case(assignment):
    (valid, open_sig, core, host, hib, open_host, req, _, _, _), outputs = v1_case(assignment)
    C, FRp, S_pad = 1, 8, 4
    front_j = np.zeros((C, FRp, S_pad), np.float32)
    front_j[0, :2, 0] = (2, 2)
    compat_j = np.zeros((C, 8, S_pad), np.float32)
    compat_j[0, 0, 0] = 1
    jvals = np.zeros((C, 8, S_pad), np.float32)
    args = (
        np.stack([valid, open_sig, core, host, hib, open_host]).astype(np.int32),
        np.ascontiguousarray(req.T),
        front_j, compat_j, jvals,
        np.ones((1, 3), np.int32),
        np.zeros((2, 1), np.float32),
    )
    return args, outputs


def test_v2_work_counts_the_replay_and_the_table_reads():
    args, outputs = v2_case([0, 0, 1])
    n_bytes, ops = roofline.v2_work(args, outputs[0], outputs, F=1, R=2)
    assert ops == 13
    pod_side = args[0].nbytes + args[1].nbytes + args[5].nbytes + args[6].nbytes
    # one joinability, one frontier row of 2 floats, one joined id
    assert n_bytes == pod_side + sum(o.nbytes for o in outputs) + 4 * (1 + 2 + 1)
    args, outputs = v2_case([0, 1, 1])
    with pytest.raises(AssertionError):
        roofline.v2_work(args, outputs[0], outputs, F=1, R=2)


def test_bound_takes_the_slower_of_bytes_and_operations():
    ms, by = roofline.bound(3.35e9, 1)
    assert ms == pytest.approx(1.0) and by == "bytes"
    ms, by = roofline.bound(1, 67e9)
    assert ms == pytest.approx(1.0) and by == "operations"
