"""The C side of each hand-written kernel against the ctypes signature that binds it.

Every ``extern "C"`` entry of ``denovo_kmer_tpu_torch/csrc/*.cu`` is parsed from its source
and its parameters are held against the ``_ARGTYPES`` list of the module that loads it:
the same count, and a pointer where the C side takes a pointer, a 32-bit int where it takes
an ``int`` and a 64-bit int where it takes a ``long long``. ctypes passes whatever it is
told, so a mismatch would only show on the card as a wrong pointer or a cut 64-bit value;
the sources cannot be compiled here, so this is the guard on the ABI on the CPU."""

import ctypes
import os
import re

import pytest

from denovo_kmer_tpu_torch.ops import block_sort, extract, partition, table_merge
from denovo_kmer_tpu_torch.utils.cuda_build import CSRC

#: extern "C" entry of each kernel source, and the module whose _ARGTYPES bind it
BINDINGS = {
    "extract_kmers": ("dk_extract_kmers_append", extract),
    "radix_partition": ("dk_radix_partition", partition),
    "block_sort": ("dk_block_sort", block_sort),
    "table_merge": ("dk_table_merge", table_merge),
}

_KINDS = {"pointer": ctypes.c_void_p, "int": ctypes.c_int, "long long": ctypes.c_longlong}


def _c_entries(source: str):
    """{name: [parameter kind, ...]} of every ``extern "C" int name(...)`` in ``source``."""
    out = {}
    for m in re.finditer(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', source):
        kinds = []
        for param in m.group(2).split(","):
            decl = " ".join(param.split())
            if "*" in decl:
                kinds.append("pointer")
            elif re.match(r"(const\s+)?long\s+long\s+\w+$", decl):
                kinds.append("long long")
            elif re.match(r"(const\s+)?int\s+\w+$", decl):
                kinds.append("int")
            else:
                raise AssertionError(f"unrecognised parameter {decl!r} of {m.group(1)}")
        out[m.group(1)] = kinds
    return out


def _source(name):
    with open(os.path.join(CSRC, f"{name}.cu")) as f:
        return f.read()


def test_every_kernel_source_is_bound():
    sources = sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))
    assert sources == sorted(BINDINGS)
    for name, (entry, _) in BINDINGS.items():
        assert list(_c_entries(_source(name))) == [entry], name


@pytest.mark.parametrize("name", sorted(BINDINGS))
def test_argtypes_match_the_c_entry(name):
    entry, module = BINDINGS[name]
    kinds = _c_entries(_source(name))[entry]
    assert [_KINDS[k] for k in kinds] == module._ARGTYPES


def test_parser_reads_every_kind():
    src = 'extern "C" int dk_x(const void* a, long long n,\n    int k, void* out) {'
    assert _c_entries(src) == {"dk_x": ["pointer", "long long", "int", "pointer"]}
    with pytest.raises(AssertionError, match="unrecognised"):
        _c_entries('extern "C" int dk_y(float f) {')
