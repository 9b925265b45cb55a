"""K6 (kernels/csrc/bam_ingest.cu), the card pass over a BGZF BAM, on the
card against its plain version (ingest/card.py plain_pass) and against the
engine alone: inflate on zlib streams of every level and strategy, a
flipped CRC, members cut inside records and inside block_size fields, the
pair test and the reduction on every kind of record, and the CLI's outputs
byte for byte. Marked ``cuda``; they skip without a card. Nothing here
imports the JAX package."""

import struct
import zlib

import numpy as np
import pytest
import torch

from arriba_tpu_torch import kernels
from arriba_tpu_torch.ingest import card
from arriba_tpu_torch.io.bam import read_bam_header

from .bam_build import (assert_same, edge_sample, member, record_starts, run,
                        spy, tile_runs)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def bam_like(rng, size: int) -> bytes:
    """Bytes that deflate as a BAM does: matches and noise."""
    parts = [bytes(rng.integers(65, 70, 40, dtype=np.uint8))
             + b"ACGTTGCA" * int(rng.integers(0, 5))
             for _ in range(size // 40 + 1)]
    return b"".join(parts)[:size]


def inflate_on_card(members):
    """Launch K6's inflate on members (bytes each) at once; (outputs,
    statuses)."""
    dev = torch.device("cuda")
    comp = b"".join(members)
    offsets = np.cumsum([0] + [len(m) for m in members[:-1]])
    isizes = [struct.unpack_from("<I", m, len(m) - 4)[0] for m in members]
    out_offsets = np.cumsum([0] + isizes[:-1])
    comp_dev = torch.frombuffer(bytearray(comp + b"\0" * 8),
                                dtype=torch.uint8).to(dev)
    meta = [torch.tensor(np.asarray(x, np.int64), device=dev)
            for x in (offsets, [len(m) for m in members], out_offsets)]
    out = torch.zeros(sum(isizes) + 8, dtype=torch.uint8, device=dev)
    status = torch.full((len(members),), -1, dtype=torch.int32, device=dev)
    stats = torch.zeros(16, dtype=torch.int64, device=dev)
    kernels.launch_bgzf_inflate(comp_dev, *meta, out, status, stats)
    torch.cuda.synchronize()
    host = out.cpu().numpy().tobytes()
    outputs = [host[o:o + n] for o, n in zip(out_offsets, isizes)]
    return outputs, status.cpu().tolist(), int(stats[3])


@pytest.mark.cuda
@pytest.mark.parametrize("level", range(10))
def test_inflate_kernel_matches_zlib(cuda, level):
    rng = np.random.default_rng(level)
    texts, members = [], []
    for size in (0, 1, 300, 4096, 65280):
        for strategy in (zlib.Z_DEFAULT_STRATEGY, zlib.Z_FIXED,
                         zlib.Z_HUFFMAN_ONLY, zlib.Z_RLE):
            text = bam_like(rng, size)
            texts.append(text)
            members.append(member(text, level, strategy))
    before = kernels.launch_counts["bgzf_inflate"]
    outputs, status, failed = inflate_on_card(members)
    assert kernels.launch_counts["bgzf_inflate"] == before + 1
    assert status == [0] * len(members) and failed == 0
    assert outputs == texts


@pytest.mark.cuda
def test_inflate_kernel_refuses_a_flipped_crc(cuda):
    rng = np.random.default_rng(3)
    members = [member(bam_like(rng, 20000), 6) for _ in range(5)]
    bad = bytearray(members[2])
    bad[-6] ^= 0x10
    members[2] = bytes(bad)
    _, status, failed = inflate_on_card(members)
    assert status == [0, 0, 8, 0, 0] and failed == 1  # BI_ERR_CRC


def card_backend(small: bool, monkeypatch):
    if small:
        monkeypatch.setattr(card, "READ_BYTES", 4096)
        monkeypatch.setattr(card, "CHUNK_OUT", 12288)
        monkeypatch.setattr(card, "MAX_CARRY", 4096)
        monkeypatch.setattr(card, "RESIDUE_PIECE", 1000)
        return card.card_pass


@pytest.mark.cuda
def test_card_pass_matches_the_plain_pass(cuda, tmp_path, monkeypatch):
    """One chunk: the kernels take the same pairs, coverage (past 0xFFFF,
    saturated) and residue as the plain pass."""
    sample = edge_sample(tmp_path, saturate=70000)
    args = sample.write(cuts=[700, 701, 5000, 5003])
    plain, on_card = [], []
    a = run(monkeypatch, args, tmp_path, "plain", spy(card.plain_pass, plain),
            device="cuda")
    b = run(monkeypatch, args, tmp_path, "card", spy(card.card_pass, on_card),
            device="cuda")
    assert_same(a, b)
    p, c = plain[0], on_card[0]
    assert (p.taken, p.residue, p.mapped, p.chains, p.placeholders) \
        == (c.taken, c.residue, c.mapped, c.chains, c.placeholders)
    assert p.coverage.max() > 0xFFFF
    assert np.array_equal(np.minimum(p.coverage, 0xFFFF),
                          c.coverage.cpu().numpy().view(np.uint16))
    assert np.array_equal(p.starts, c.starts.cpu().numpy())
    assert np.array_equal(p.ends, c.ends.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("cuts", ["members", "block_size", "records"])
def test_card_chunks_leave_the_engines_outputs(cuda, tmp_path, monkeypatch,
                                              cuts):
    """Chunks of a few records: members cut inside block_size fields,
    records, pairs and runs of one name across chunks."""
    sample = edge_sample(tmp_path, saturate=40)
    tile_runs(sample, runs=6)
    raw = sample.raw()
    starts = record_starts(raw)
    if cuts == "members":
        offsets = list(range(1000, len(raw), 1777))
    elif cuts == "block_size":
        offsets = [s + 1 + (k % 3) for k, s in enumerate(starts[::5])]
    else:
        offsets = starts[::3]
    args = sample.write(cuts=offsets, size=3000)
    alone = run(monkeypatch, args, tmp_path, "alone", None, device="cuda")
    seen, asked, bases = [], [], []
    backend = card_backend(True, monkeypatch)
    residue = kernels.launch_bam_residue
    monkeypatch.setattr(kernels, "launch_bam_residue",
                        lambda *a: bases.append(a[3]) or residue(*a))

    def kept(path, contigs):
        result = backend(path, contigs)
        asked.append((path, contigs, open(result.path, "rb").read()))
        return result

    passed = run(monkeypatch, args, tmp_path, "card", spy(kept, seen),
                 device="cuda")
    assert_same(alone, passed)
    assert seen[0].taken > 0 and seen[0].chains > 0
    # the plain pass cut where the card's chunks fell
    path, contigs, card_residue = asked[0]
    plain = card.plain_pass(path, contigs, cuts=[b for b in bases if b > 0])
    try:
        p, c = plain, seen[0]
        assert (p.taken, p.residue, p.mapped, p.chains, p.placeholders) \
            == (c.taken, c.residue, c.mapped, c.chains, c.placeholders)
        assert open(plain.path, "rb").read() == card_residue
        assert np.array_equal(np.minimum(p.coverage, 0xFFFF),
                              c.coverage.cpu().numpy().view(np.uint16))
    finally:
        plain.close()


@pytest.mark.cuda
def test_card_pass_holds_runs_at_their_tile(cuda, tmp_path, monkeypatch):
    sample = edge_sample(tmp_path)
    tile_runs(sample)
    args = sample.write()
    alone = run(monkeypatch, args, tmp_path, "alone", None, device="cuda")
    off = run(monkeypatch, args, tmp_path, "off", None, device="off")
    seen = []
    passed = run(monkeypatch, args, tmp_path, "card", spy(card.card_pass, seen),
                 device="cuda")
    assert_same(alone, passed)
    assert off[1:4] == passed[1:4]
    assert seen[0].placeholders > 0


@pytest.mark.cuda
def test_card_pass_falls_back_on_a_flipped_crc(cuda, tmp_path, monkeypatch):
    args = edge_sample(tmp_path, saturate=3000).write(level=0)
    path = args[args.index("-x") + 1]
    data = bytearray(open(path, "rb").read())
    data[-28 - 6] ^= 0x01
    open(path, "wb").write(bytes(data))
    contigs = card.Contigs(read_bam_header(path).raw, np.zeros(0, np.int64),
                           np.zeros(4, np.int64), np.array([0, 10, 20, 30]),
                           np.ones(3, np.uint8), np.zeros(3, np.uint8), False)
    with pytest.raises(card.Fallback):
        card.card_pass(path, contigs)
    errors = []
    for label, chosen in (("alone", None), ("card", "card")):
        with pytest.raises(Exception) as caught:
            rc = run(monkeypatch, args, tmp_path, label, chosen,
                     device="cuda")[0]
            assert rc != 0
            raise RuntimeError("the run failed with its status")
        errors.append((type(caught.value), str(caught.value)))
    assert errors[0] == errors[1]
