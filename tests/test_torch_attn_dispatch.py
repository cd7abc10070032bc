"""``ops.kernels.attn_instance``, the one rule that picks the single-block
attention pair's instance, over every head dim 1 .. 800 and sequence
length 1 .. 512, and the wrappers that hand its choice to the library
(``csrc/seg_attention.cu:nbk_seg_attention``,
``csrc/seg_attention_bwd.cu:nbk_seg_attention_bwd``, and at the head dims
``chunked_head_dim`` names the chunked family of
``csrc/attention_chunked.cu``); the tiled trio's wrappers, which hand the
library the caller's head dim (the library picks the instance:
``kernels.FLASH_WGMMA``, and the chunked family at the chunked head
dims); the wgmma counters by head dim of both, and the chunked family's
counters.  The card tests (``tests/test_torch_kernels_cuda.py``)
and ``chip_smoke.py`` phase 18 hold the kernels' launch counters to
them."""

import pathlib
import re

import pytest
import torch

from nbest_asr_tpu_torch.ops import _cuda
from nbest_asr_tpu_torch.ops import kernels as K

# the instance table: (d, s) -> (forward, backward)
TABLE = {(64, 20): ("wgmma", "wgmma"), (64, 256): ("wgmma", "wgmma"),
         (64, 257): ("wgmma", "wgmma"), (64, 512): ("wgmma", "wgmma"),
         (96, 1): ("wgmma", "wgmma"), (96, 256): ("wgmma", "wgmma"),
         (96, 257): (96, 96), (96, 512): (96, 96),
         (48, 160): (64, 64), (72, 160): (96, 96), (80, 256): (96, 96),
         (88, 64): (96, 96), (8, 64): (32, 32), (32, 160): (32, 32),
         (128, 256): (128, 128), (192, 256): ("wgmma", "wgmma"),
         (192, 64): ("wgmma", "wgmma"), (192, 257): ("wgmma", "wgmma"),
         (192, 512): ("wgmma", "wgmma"), (184, 300): (192, 192),
         (160, 256): (192, 192),
         (256, 512): (256, 256), (12, 64): ("chunked", "chunked"),
         (264, 64): ("chunked", "chunked"), (3, 1): ("chunked", "chunked"),
         (320, 512): ("chunked", "chunked"),
         (768, 256): ("chunked", "chunked"), (64, 513): (None, None),
         (96, 0): (None, None), (0, 64): (None, None),
         (320, 513): (None, None)}


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
def test_attn_instance_over_every_head_dim_and_length(backward):
    seen = {}
    for d in range(1, 801):
        left_wgmma = False
        for s in range(0, 514):
            got = K.attn_instance(d, s, backward)
            seen[got] = seen.get(got, 0) + 1
            # refused exactly where the wrappers refuse: lengths outside
            # the single block, at no head dim
            assert (got is None) == (not 1 <= s <= 512), (d, s, got)
            if got is None:
                continue
            # the chunked family exactly at d > 256 or d % 8 != 0
            assert (got == "chunked") == (d > 256 or d % 8 != 0), (d, s)
            if got == "chunked":
                continue
            if got == "wgmma":
                # one window of lengths from 1, at the wgmma head dims
                assert d in (64, 96, 192) and not left_wgmma, (d, s)
            else:
                # a mma.sync instance at least d wide, padding < 64 columns
                assert d <= got < d + 64 and got % 32 == 0, (d, s, got)
                left_wgmma = True
    # every instance is reached
    assert set(seen) == {None, "chunked", "wgmma", 32, 64, 96, 128, 192,
                         256}
    for (d, s), want in TABLE.items():
        assert K.attn_instance(d, s, backward) == want[backward], (d, s)


@pytest.fixture
def keep_launch_counts():
    """Puts ``_cuda.launch_counts`` back as it was after a test whose
    wrappers launch through a fake library (and so count), so that the
    faked launches do not reach other tests of the same process."""
    saved = dict(_cuda.launch_counts)
    yield
    _cuda.launch_counts.clear()
    _cuda.launch_counts.update(saved)


class _FakeLib:
    """Records the instance each launch names (the argument after d), and
    the head dim each tiled launch names; the wgmma counters read
    ``launches[d]`` (the tiled ones ``launches[(kernel, d)]``)."""

    def __init__(self, launches=None):
        self.calls = []
        self.launches = launches or {}

    def nbk_seg_attention_wgmma_launches(self, d):
        return self.launches[d]

    def nbk_seg_attention_bwd_wgmma_launches(self, d):
        return -self.launches[d]

    def nbk_flash_fwd_wgmma_launches(self, d):
        return self.launches[("flash_fwd", d)]

    def nbk_flash_bwd_wgmma_launches(self, dkv, d):
        return self.launches[("flash_bwd_dkv" if dkv else "flash_bwd_dq",
                              d)]

    def nbk_flash_fwd(self, *a):
        self.calls.append(("flash_fwd", a[10]))       # ..., n_heads, d
        return 0

    def nbk_flash_bwd_dq(self, *a):
        self.calls.append(("flash_bwd_dq", a[14]))
        return 0

    def nbk_flash_bwd_dkv(self, *a):
        self.calls.append(("flash_bwd_dkv", a[14]))
        return 0

    def nbk_seg_attention(self, *a):
        self.calls.append(("fwd", a[10], a[11]))      # ..., d, instance
        return 0

    def nbk_seg_attention_bwd(self, *a):
        self.calls.append(("bwd", a[15], a[16]))
        return 0

    def nbk_chunked_fwd(self, *a):
        # ..., st0, st1, tiled, B, S, n_heads, d
        self.calls.append(("chunked_fwd", a[12], a[8]))
        return 0

    def nbk_chunked_bwd_dq(self, *a):
        # ..., o (None: the single-block di), ..., B, S, n_heads, d
        self.calls.append(("chunked_bwd_dq", a[15], a[4] is not None))
        return 0

    def nbk_chunked_bwd_dkv(self, *a):
        self.calls.append(("chunked_bwd_dkv", a[15]))
        return 0

    def nbk_chunked_launches(self, kernel):
        return self.launches[("chunked", kernel)]

    def nbk_chunked_fwd_instance_launches(self, inst):
        return self.launches[("chunked_fwd", inst)]


@pytest.mark.usefixtures("keep_launch_counts")
@pytest.mark.parametrize("layout", ["qkv", "bshd"])
@pytest.mark.parametrize("d,s", [(64, 300), (64, 512), (96, 256), (96, 257),
                                 (88, 160), (128, 64), (192, 256),
                                 (192, 300), (12, 160), (3, 77),
                                 (320, 256), (768, 512)])
def test_wrappers_pass_attn_instance_to_the_kernels(monkeypatch, layout, d,
                                                    s):
    """The four wrappers hand the library ``attn_instance``'s choice (0
    for wgmma, else the mma.sync width): the forward's to
    ``nbk_seg_attention``, the backward's to ``nbk_seg_attention_bwd``."""
    fake = _FakeLib()
    monkeypatch.setattr(_cuda, "lib", lambda: fake)
    monkeypatch.setattr(K, "_on_cuda", lambda name, *t: True)
    monkeypatch.setattr(K, "_stream", lambda t: 0)
    b, nh = 1, 2
    h = nh * d
    mask = torch.ones(b, s)
    if layout == "qkv":
        qkv = torch.zeros(b * s, 3 * h, dtype=torch.bfloat16)
        _, st = K.seg_attention(qkv, mask, nh, stats=True)
        K.seg_attention_bwd(qkv, torch.zeros(b * s, h, dtype=torch.bfloat16),
                            mask, st, nh)
    else:
        q, k, v, do = (torch.zeros(b, s, nh, d, dtype=torch.bfloat16)
                       for _ in range(4))
        _, st = K.sb_attention(q, k, v, mask, 0.1, stats=True)
        K.sb_attention_bwd(q, k, v, do, mask, st, 0.1)

    def arg(inst):
        return 0 if inst == "wgmma" else inst

    if K.chunked_head_dim(d):
        # the single-block contract (tiled 0, di from the dQ kernel's key
        # sweep): the forward, then the dQ and the dK/dV kernels
        assert fake.calls == [("chunked_fwd", d, 0),
                              ("chunked_bwd_dq", d, False),
                              ("chunked_bwd_dkv", d)]
    else:
        assert fake.calls == [("fwd", d, arg(K.attn_instance(d, s))),
                              ("bwd", d, arg(K.attn_instance(d, s, True)))]
    assert _cuda.launch_counts["seg_attention"] >= 1


def test_wgmma_counters_refuse_head_dims_without_a_wgmma_instance(
        monkeypatch):
    """A per-width count at a head dim with no wgmma instance would read
    0 whatever ran, so the counters refuse it (before reaching the
    library); at the wgmma head dims, and 0 for all of them, they read the
    library's count."""
    fake = _FakeLib({0: 6, 64: 1, 96: 2, 192: 3})
    monkeypatch.setattr(_cuda, "lib", lambda: fake)
    for d in (0, 64, 96, 192):
        assert K.seg_attention_wgmma_launches(d) == fake.launches[d]
        assert K.seg_attention_bwd_wgmma_launches(d) == -fake.launches[d]
    for d in (32, 48, 80, 88, 128, 136, 256):
        with pytest.raises(ValueError, match="no wgmma instance"):
            K.seg_attention_wgmma_launches(d)
        with pytest.raises(ValueError, match="no wgmma instance"):
            K.seg_attention_bwd_wgmma_launches(d)


@pytest.mark.usefixtures("keep_launch_counts")
@pytest.mark.parametrize("d", range(8, 257, 8))
def test_tiled_wrappers_pass_the_head_dim(monkeypatch, d):
    """The tiled trio's wrappers hand the library the caller's head dim at
    every d the kernels take (d <= 256, d % 8 == 0), on q, k, v views of
    one QKV buffer at a length past the single-block route's: the library
    picks the instance (csrc/flash_attention.cu, flash_attention_bwd.cu),
    wgmma + TMA where ``FLASH_WGMMA`` names one, else the mma.sync
    instance at least d wide, and its counters show which ran."""
    fake = _FakeLib()
    monkeypatch.setattr(_cuda, "lib", lambda: fake)
    monkeypatch.setattr(K, "_on_cuda", lambda name, *t: True)
    monkeypatch.setattr(K, "_stream", lambda t: 0)
    b, s, nh = 1, 600, 2
    q, k, v = torch.zeros(b * s, 3 * nh * d, dtype=torch.bfloat16).view(
        b, s, 3, nh, d).unbind(2)
    do = torch.zeros(b, s, nh, d, dtype=torch.bfloat16)
    mask = torch.ones(b, s)
    o, lse = K.flash_fwd(q, k, v, mask, 0.1)
    _, di = K.flash_bwd_dq(q, k, v, mask, o, lse, do, 0.1)
    K.flash_bwd_dkv(q, k, v, mask, lse, di, do, 0.1)
    assert fake.calls == [("flash_fwd", d), ("flash_bwd_dq", d),
                          ("flash_bwd_dkv", d)]
    assert {n: _cuda.launch_counts[n] for n in K.FLASH_WGMMA} == {
        n: 1 for n in K.FLASH_WGMMA}


@pytest.mark.usefixtures("keep_launch_counts")
def test_tiled_wrappers_hand_every_head_dim_to_the_library(monkeypatch):
    """At every head dim 1 .. 800 the tiled trio's wrappers take the
    operands -- at the chunked head dims views of one QKV buffer at any
    alignment -- and hand the library's tiled entry points the caller's
    d, each counting one launch; the library hands the head dims
    ``chunked_head_dim`` names to the chunked family by the same rule
    (``csrc/attention_chunked.cuh``, read here)."""
    src = (pathlib.Path(K.__file__).parent.parent / "csrc" /
           "attention_chunked.cuh").read_text()
    rule = re.search(r"bool chunked_head_dim\(int d\) \{ return (.*?); \}",
                     src).group(1)
    fake = _FakeLib()
    monkeypatch.setattr(_cuda, "lib", lambda: fake)
    monkeypatch.setattr(K, "_on_cuda", lambda name, *t: True)
    monkeypatch.setattr(K, "_stream", lambda t: 0)
    b, s, nh = 1, 3, 2
    mask = torch.ones(b, s)
    for d in range(1, 801):
        assert eval(rule.replace("||", "or"), {"d": d}) == (
            K.chunked_head_dim(d)) == (d > 256 or d % 8 != 0), d
        fake.calls.clear()
        _cuda.reset_launch_counts()
        q, k, v = torch.zeros(b * s, 3 * nh * d, dtype=torch.bfloat16).view(
            b, s, 3, nh, d).unbind(2)
        do = torch.zeros(b, s, nh, d, dtype=torch.bfloat16)
        o, lse = K.flash_fwd(q, k, v, mask, 0.1)
        _, di = K.flash_bwd_dq(q, k, v, mask, o, lse, do, 0.1)
        K.flash_bwd_dkv(q, k, v, mask, lse, di, do, 0.1)
        assert fake.calls == [("flash_fwd", d), ("flash_bwd_dq", d),
                              ("flash_bwd_dkv", d)], d
        assert {n: _cuda.launch_counts[n] for n in K.FLASH_WGMMA} == {
            n: 1 for n in K.FLASH_WGMMA}, d


def test_chunked_counters_read_the_library_per_kernel(monkeypatch):
    """``attn_chunked_launches`` reads the library's count of each chunked
    kernel (0 forward, 1 dQ, 2 dK/dV)."""
    fake = _FakeLib({("chunked", i): 10 + i for i in range(3)})
    monkeypatch.setattr(_cuda, "lib", lambda: fake)
    assert K.attn_chunked_launches() == {"chunked_fwd": 10,
                                         "chunked_bwd_dq": 11,
                                         "chunked_bwd_dkv": 12}
    assert K.CHUNKED == tuple(K.attn_chunked_launches())


def test_tiled_wgmma_counters_by_head_dim(monkeypatch):
    """The tiled trio's wgmma counters read the library's count per kernel
    at d = 64, at d = 96 and at 0 for all; a head dim with no tiled wgmma
    instance is refused before the library is asked, as its count would
    read 0 whatever ran."""
    assert K.FLASH_WGMMA == {"flash_fwd": (64, 96), "flash_bwd_dq": (64, 96),
                             "flash_bwd_dkv": (64, 96)}
    launches = {("flash_fwd", 0): 10, ("flash_fwd", 64): 7,
                ("flash_fwd", 96): 3, ("flash_bwd_dq", 0): 9,
                ("flash_bwd_dq", 64): 4, ("flash_bwd_dq", 96): 5,
                ("flash_bwd_dkv", 0): 11, ("flash_bwd_dkv", 64): 5,
                ("flash_bwd_dkv", 96): 6}
    fake = _FakeLib(launches)
    monkeypatch.setattr(_cuda, "lib", lambda: fake)
    for d in (0, 64, 96):
        assert K.flash_wgmma_launches(d) == {
            n: launches[(n, d)] for n in K.FLASH_WGMMA}
    assert K.flash_wgmma_launches() == K.flash_wgmma_launches(0)
    for d in (32, 48, 80, 88, 128, 136, 192, 256):
        with pytest.raises(ValueError, match="no wgmma instance"):
            K.flash_wgmma_launches(d)


@pytest.mark.usefixtures("keep_launch_counts")
@pytest.mark.parametrize("d", [72, 80, 88, 96])
def test_tiled_forward_hands_d96_to_wgmma(monkeypatch, d):
    """The tiled forward runs on its wgmma + TMA instance at d = 96, as the
    backward pair does, and the padded head dims 72 .. 88 stay on the
    mma.sync 96 instance (a TMA box 96 columns wide would read the next
    head's): ``FLASH_WGMMA`` names 96 and none of 72 .. 88 for every tiled
    kernel; ``flash_fwd`` hands the library the caller's d, counts the
    launch, and its wgmma counter reads the library's d = 96 count, while
    a count at 72 .. 88 is refused."""
    assert all((d in dims) == (d == 96) for dims in K.FLASH_WGMMA.values())
    fake = _FakeLib({(n, 96): 1 for n in K.FLASH_WGMMA})
    monkeypatch.setattr(_cuda, "lib", lambda: fake)
    monkeypatch.setattr(K, "_on_cuda", lambda name, *t: True)
    monkeypatch.setattr(K, "_stream", lambda t: 0)
    b, s, nh = 1, 600, 2
    q, k, v = torch.zeros(b * s, 3 * nh * d, dtype=torch.bfloat16).view(
        b, s, 3, nh, d).unbind(2)
    n0 = _cuda.launch_counts["flash_fwd"]
    K.flash_fwd(q, k, v, torch.ones(b, s), 0.1)
    assert fake.calls == [("flash_fwd", d)]
    assert _cuda.launch_counts["flash_fwd"] == n0 + 1
    if d == 96:
        assert K.flash_wgmma_launches(d)["flash_fwd"] == 1
    else:
        with pytest.raises(ValueError, match="no wgmma instance"):
            K.flash_wgmma_launches(d)


def _chunked_source() -> str:
    return (pathlib.Path(K.__file__).parent.parent / "csrc" /
            "attention_chunked.cu").read_text()


def test_chunked_fwd_instance_over_every_head_dim():
    """``chunked_fwd_instance``, the library's instance rule
    (``csrc/attention_chunked.cu:fwd_instance``, read here) over every
    head dim 1 .. 800: the narrowest slab at least ceil16(d) wide with Q
    resident, and past 384 columns the streamed-Q instance, which takes
    its 384-column slabs in turn; every instance is reached, and each
    launch case of ``nbk_chunked_fwd`` is the slab its name says."""
    src = _chunked_source()
    body = re.search(r"int fwd_instance\(int d\) \{(.*?)\n\}", src,
                     re.S).group(1)
    bounds = [(int(w), int(i)) for w, i in
              re.findall(r"d16 <= (\d+)\s*\?\s*(\d)", body)]
    last = int(re.search(r":\s*(\d);", body).group(1))
    cases = {int(i): (int(nwg), int(pw), int(nc), qres == "true")
             for i, nwg, pw, nc, qres in re.findall(
                 r"NBK_CHUNKED_FWD\((\d), (\d), (\d+), (\d), (true|false)\)",
                 src)}
    assert sorted(cases) == list(range(len(K.CHUNKED_FWD_INSTANCES)))
    for i, (nwg, pw, nc, qres) in cases.items():
        name = K.CHUNKED_FWD_INSTANCES[i]
        assert name.startswith(f"slab{nwg * pw * nc}"), (i, name)
        assert qres == (name != "slab384_streamed_q"), (i, name)
    seen = set()
    for d in range(1, 801):
        got = K.chunked_fwd_instance(d)
        seen.add(got)
        d16 = -(-d // 16) * 16
        c_inst = next((i for w, i in bounds if d16 <= w), last)
        assert got == K.CHUNKED_FWD_INSTANCES[c_inst], d
        if got == "slab384_streamed_q":
            assert d16 > 384, d
        else:
            w = int(got[4:])
            # the narrowest slab that holds the head's k16 steps
            assert d16 <= w and all(d16 > v for v in (32, 64, 128, 192, 384)
                                    if v < w), d
    assert seen == set(K.CHUNKED_FWD_INSTANCES)
    for d, want in ((3, "slab32"), (12, "slab32"), (20, "slab32"),
                    (44, "slab64"), (100, "slab128"), (150, "slab192"),
                    (202, "slab384"), (258, "slab384"), (384, "slab384"),
                    (385, "slab384_streamed_q"),
                    (768, "slab384_streamed_q")):
        assert K.chunked_fwd_instance(d) == want, d
    with pytest.raises(ValueError):
        K.chunked_fwd_instance(0)


def test_chunked_fwd_instance_counters_read_the_library(monkeypatch):
    """``chunked_fwd_instance_launches`` reads the library's count of each
    ``chunked_fwd`` instance, in ``CHUNKED_FWD_INSTANCES`` order."""
    fake = _FakeLib({("chunked_fwd", i): 20 + i for i in range(6)})
    monkeypatch.setattr(_cuda, "lib", lambda: fake)
    assert K.chunked_fwd_instance_launches() == {
        name: 20 + i for i, name in enumerate(K.CHUNKED_FWD_INSTANCES)}
