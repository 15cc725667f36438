"""K5 `dyn_rollout_fwd` and K7 `dyn_rollout_ee_fwd`: the launch routing.

The forwards run on the instantiation `kernel_variant` picks, as K6/K8's
phases do: serial chains of a built shape (iiwa, panda_no_gripper,
fetch_arm, the 2-link robot) a scenario on a group of lanes below the
card's switch batch and one thread a scenario from it, every other robot
one thread a scenario on the generic 16- or 32-link build. Their launch is
checked for each of the 13 bundled URDFs (the variant table of
tests/test_torch_rnea_reverse.py) without a card: the arguments
`_fwd_launch` hands the library (the variant's code, the by-value structs,
the pointers, H and B) against the entry's declaration in `_configure`,
and the declaration of the switch query.

The group step is `drm_rr_fd_accel`'s arithmetic spread over lanes (it
reads K7's ee position off the world-pose sweep, which is the chain
sweep's arithmetic), so the kernels' plain versions stay
`dyn_rollout_fwd_reference` / `dyn_rollout_ee_fwd_reference`, which
tests/test_torch_dyn_rollout.py holds to the JAX package.
"""

import ctypes
import functools
import os

import pytest
import torch
from test_torch_rnea_reverse import EXPECTED_VARIANT

from differentiable_robot_model_tpu_torch.models.robot import robot_description_folder
from differentiable_robot_model_tpu_torch.models.urdf import robot_struct_from_urdf
from differentiable_robot_model_tpu_torch.ops.kernels import rollout as kr

DT = 0.02
B, H = 6, 5


class _Entry:
    """An entry of the library: `_configure` sets its declaration."""

    argtypes = restype = None

    def __call__(self, sizes):
        # the layout query, answered with what Python expects, so that only
        # the declarations are under test
        sizes[:10] = [
            ctypes.sizeof(kr.TREE_CTYPES[torch.float32]), ctypes.sizeof(kr.TREE_CTYPES[torch.float64]),
            ctypes.sizeof(kr.CHAIN_CTYPES[torch.float32]), ctypes.sizeof(kr.CHAIN_CTYPES[torch.float64]),
            kr.MAX_LINKS, 9, 7, 4, 2, kr.replay_layout(7, False, False).K,
        ]


class _Library:
    """Stands in for the built csrc/dyn_rollout.cu."""

    def __init__(self):
        self.entries = {}

    def __getattr__(self, name):
        return self.entries.setdefault(name, _Entry())


@functools.lru_cache(maxsize=None)
def _declared():
    lib = _Library()
    kr._configure(lib)
    return lib.entries


@pytest.mark.filterwarnings("ignore:No dynamics information")
@pytest.mark.parametrize("urdf", sorted(EXPECTED_VARIANT))
def test_forward_launch_routes_by_variant(urdf, monkeypatch):
    assert sorted(EXPECTED_VARIANT) == sorted(
        f for f in os.listdir(robot_description_folder) if f.endswith(".urdf"))
    s = robot_struct_from_urdf(os.path.join(robot_description_folder, urdf), device="cpu")
    D = s.n_dofs
    calls = []
    monkeypatch.setattr(kr, "_launch", lambda name, args, dev: calls.append((name, args, dev)))
    q0, qd0, tau = torch.zeros((D, B)), torch.zeros((D, B)), torch.zeros((H, D, B))
    outs = (torch.empty_like(tau), torch.empty_like(tau), torch.empty((H, 3, B)))
    flags = kr.StepFlags(DT)
    kr._fwd_launch(s, flags, None, q0, qd0, tau, outs[:2])
    kr._fwd_launch(s, flags, s.n_links - 1, q0, qd0, tau, outs)
    variant = kr.VARIANTS.index(EXPECTED_VARIANT[urdf])
    assert kr.kernel_variant(s) == EXPECTED_VARIANT[urdf]
    for (name, args, dev), n_structs, n_out in zip(calls, (1, 2), (2, 3)):
        assert name == ("dyn_rollout_fwd_f32" if n_structs == 1 else "dyn_rollout_ee_fwd_f32")
        assert args[0] == variant and dev == tau.device
        # the entry's declaration: the leading ints, then one pointer a struct
        # and a tensor, then H, then B (int64), then the stream
        types = _declared()[name].argtypes
        assert len(types) == len(args) + 1 and types[-1] is ctypes.c_void_p
        lead = sum(t is ctypes.c_int for t in types[:types.index(ctypes.c_void_p)])
        assert all(isinstance(a, int) for a in args[:lead])
        structs = args[lead:lead + n_structs]
        assert [type(x._obj) for x in structs] == (
            [kr.TREE_CTYPES[torch.float32], kr.CHAIN_CTYPES[torch.float32]][:n_structs])
        ptrs = args[lead + n_structs:-2]
        assert ptrs == tuple(x.data_ptr() for x in (q0, qd0, tau, *outs[:n_out]))
        assert types[lead:lead + n_structs + len(ptrs)] == [ctypes.c_void_p] * (n_structs + len(ptrs))
        assert args[-2:] == (H, B) and types[-3:-1] == [ctypes.c_int, ctypes.c_int64]


def test_one_thread_switch_declared():
    fn = _declared()["dyn_rollout_fwd_one_thread_from"]
    assert fn.argtypes == [] and fn.restype is ctypes.c_int64
