"""The one launch path of the eleven kernel wrappers (`kernels/build.py`): each
refuses a device that is neither CPU nor CUDA with the shared message before
it launches, and every entry point's ctypes signature matches its C
declaration under ``csrc/``. CPU only: nothing here builds or loads a
library."""

import ctypes
import re

import pytest
import torch

from object_detector_tpu_torch.kernels import (
    attention, bottleneck, build, conv3x3, l2norm, msda, nms, pool_bwd, requant_epilogue,
    resnet_stem, stem, stem_fp,
)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _i8(*shape):
    return _meta(*shape, dtype=torch.int8)


def _vec(n=64):
    return _meta(n)


# Wrapper name, the wrapper, and a call of it on meta tensors that pass the
# wrapper's own input checks.
WRAPPERS = [
    ("epilogue", requant_epilogue.epilogue,
     lambda f: f(_meta(2, 4, 4, 8, dtype=torch.int32), _vec(8), _vec(8), 0.1)),
    ("conv3x3", conv3x3.conv3x3,
     lambda f: f(_i8(2, 4, 4, 64), _i8(3, 3, 64, 16), _vec(16), _vec(16), out_scale=0.1)),
    ("masked_attention", attention.masked_attention,
     lambda f: f(_meta(2, 10, 64, dtype=torch.bfloat16), _meta(2, 12, 64, dtype=torch.bfloat16),
                 _meta(2, 12, 64, dtype=torch.bfloat16), 2,
                 _meta(2, 12, dtype=torch.bool))),
    ("msda", msda.msda,
     lambda f: f(_meta(2, 27, 8, 32, dtype=torch.bfloat16), ((4, 4), (2, 3), (2, 2), (1, 1)),
                 _meta(2, 7, 4, 2), _meta(2, 7, 256), _meta(2, 7, 128),
                 _meta(2, 7, dtype=torch.bool))),
    ("nms_rows", nms.nms_rows,
     lambda f: f(_meta(4, 3, 8), _meta(3, 8), max_out=4, iou_threshold=0.5,
                 score_threshold=0.0)),
    ("stem_conv12_pool", stem.stem_conv12_pool,
     lambda f: f(_i8(1, 4, 4, 64), _i8(3, 3, 64, 64), _vec(), _vec(), 0.1)),
    ("l2norm_requant", l2norm.l2norm_requant, lambda f: f(_i8(1, 2, 2, 16), _vec(16), 0.1)),
    ("max_pool_bwd", pool_bwd.max_pool_bwd,
     lambda f: f(_meta(1, 4, 4, 4), _meta(1, 4, 2, 2), _meta(1, 4, 2, 2))),
    ("resnet_stem", resnet_stem.resnet_stem,
     lambda f: f(_meta(1, 8, 8, 3), _i8(7, 7, 3, 64), _vec(), _vec(), 0.1, 0.1)),
    ("stem_fused_producer", stem_fp.stem_fused_producer,
     lambda f: f(_i8(1, 4, 4, 3), _i8(3, 3, 3, 64), _vec(), _vec(), 0.1, _i8(3, 3, 64, 64),
                 _vec(), _vec(), 0.1)),
    ("fused_bottleneck", bottleneck.fused_bottleneck,
     lambda f: f(_i8(1, 4, 4, 64), _i8(64, 64), _vec(), _vec(), _i8(3, 3, 64, 64), _vec(),
                 _vec(), _i8(64, 64), _vec(), _vec(), s1=0.1, s2=0.1, s3=0.1,
                 resid_scale=0.1)),
]


@pytest.mark.parametrize("name,wrapper,call", WRAPPERS, ids=[w[0] for w in WRAPPERS])
def test_a_wrapper_refuses_a_meta_tensor_with_the_shared_message(name, wrapper, call):
    before = wrapper.launches
    with pytest.raises(ValueError, match=f"^{name} runs on cuda or cpu tensors, got meta$"):
        call(wrapper)
    assert wrapper.launches == before


def test_every_kernel_has_entry_points_and_every_entry_point_a_kernel():
    kernels = {kernel for kernel, _ in build.ENTRY_POINTS.values()}
    assert kernels == set(build.SOURCES)


_DECL = re.compile(r'extern "C" int (\w+)\(([^)]*)\)')


def _ctype(param: str):
    if "*" in param:
        return ctypes.c_void_p
    kind = param.rsplit(None, 1)[0]
    return {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float}[kind]


@pytest.mark.parametrize("entry", sorted(build.ENTRY_POINTS))
def test_an_entry_points_argtypes_are_its_c_declaration(entry):
    kernel, argtypes = build.ENTRY_POINTS[entry]
    source = (build.CSRC_DIR / build.SOURCES[kernel]).read_text()
    decls = {name: params for name, params in _DECL.findall(source)}
    params = [p.strip() for p in decls[entry].split(",") if p.strip()]
    assert [_ctype(p) for p in params] == argtypes
