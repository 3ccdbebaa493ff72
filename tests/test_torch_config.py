"""rtrt_tpu_torch.utils.config == rtrt_tpu.utils.config: same field names,
same defaults (exact equality; the runtime parameters compare as float32,
the JAX package's dtype)."""

import dataclasses

import numpy as np
import pytest
import torch

from rtrt_tpu.utils import config as J
from rtrt_tpu_torch.utils import config as T

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["DynamicResolution", "GlobalSettings",
                                  "FeatureFlags"])
def test_launch_dataclasses_match(name):
    jc, tc = getattr(J, name), getattr(T, name)
    jf = [(f.name, f.type) for f in dataclasses.fields(jc)]
    tf = [(f.name, f.type) for f in dataclasses.fields(tc)]
    assert [n for n, _ in jf] == [n for n, _ in tf]
    assert dataclasses.asdict(jc()) == dataclasses.asdict(tc())
    assert tc.__dataclass_params__.frozen


def test_runtime_params_match():
    jp, tp = J.default_params(), T.default_params()
    assert list(jp._fields) == [f.name for f in dataclasses.fields(tp)]
    for group in jp._fields:
        jg, tg = getattr(jp, group), getattr(tp, group)
        assert list(jg._fields) == [f.name for f in dataclasses.fields(tg)]
        for field in jg._fields:
            assert np.float32(getattr(jg, field)) == \
                np.float32(getattr(tg, field)), (group, field)
