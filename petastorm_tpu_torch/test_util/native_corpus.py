"""Handwritten and fuzzed Parquet chunk corpus for the port's native libraries.

Twin of ``petastorm_tpu/test_util/native_corpus.py``. One source of
adversarial inputs, replayed from two directions:

* ``tests/test_torch_native_reader.py`` replays it through the **release**
  libraries (and the JAX package's, for the same answers) and asserts the
  error-sentinel contract: malformed bytes return a status, never crash or
  over-read;
* ``tests/test_torch_sanitized_native.py`` and ``chip_smoke.py`` replay the
  same corpus through **ASan/UBSan-instrumented** builds
  (``PSTPU_SANITIZE=address,undefined``, ``native/build.py``), where an
  over-read the release build happens to survive aborts the process.

The builders handwrite thrift compact-protocol page headers byte by byte, so
the corpus holds inputs no real writer produces (declared counts of
``2**61``, truncated headers, spliced garbage). Beyond the JAX corpus it
holds the page whose statistics declare a map of ``2**62`` bools
(:func:`map_of_bools_page`), which the port's page scan rejects and the JAX
package's scanner never returns on (so the JAX corpus cannot hold it), and
PNG cells for the image decoder (:func:`png_corpus`).
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np


def tvarint(v):
    """Thrift compact-protocol unsigned varint."""
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def tzigzag(v):
    return tvarint((v << 1) ^ (v >> 63))


def stats_struct(min_value=None, max_value=None, null_count=None,
                 max_len=None, min_len=None):
    """Thrift compact ``Statistics`` struct (fields 3/5/6 — null_count,
    max_value, min_value). ``max_len``/``min_len`` override the declared
    binary lengths to build over-declared (corrupt) stats."""
    out = b''
    last = 0
    if null_count is not None:
        out += bytes([((3 - last) << 4) | 6]) + tzigzag(null_count)
        last = 3
    if max_value is not None:
        out += (bytes([((5 - last) << 4) | 8])
                + tvarint(len(max_value) if max_len is None else max_len)
                + max_value)
        last = 5
    if min_value is not None:
        out += (bytes([((6 - last) << 4) | 8])
                + tvarint(len(min_value) if min_len is None else min_len)
                + min_value)
        last = 6
    return out + b'\x00'


def plain_page(num_values, itemsize=8, value=0, values=None, encoding=0,
               declared_raw=None, stats=None):
    """One handwritten v1 data page (thrift compact header + values).
    ``declared_raw`` overrides the declared UNCOMPRESSED size (for pages whose
    ``values`` bytes are a handwritten compressed frame); ``stats`` embeds a
    :func:`stats_struct` as DataPageHeader field 5."""
    if values is None:
        values = struct.pack('<q', value)[:itemsize] * num_values
    dph = (bytes([0x15]) + tzigzag(num_values)   # 1: num_values
           + bytes([0x15]) + tzigzag(encoding)   # 2: encoding
           + bytes([0x15]) + tzigzag(3)          # 3: def-levels RLE
           + bytes([0x15]) + tzigzag(3)          # 4: rep-levels RLE
           + (bytes([0x1C]) + stats if stats is not None else b'')  # 5: stats
           + b'\x00')
    raw_len = len(values) if declared_raw is None else declared_raw
    header = (bytes([0x15]) + tzigzag(0)                  # 1: type DATA_PAGE
              + bytes([0x15]) + tzigzag(raw_len)          # 2: uncompressed
              + bytes([0x15]) + tzigzag(len(values))      # 3: compressed
              + bytes([0x2C]) + dph                       # 5: DataPageHeader
              + b'\x00')
    return header + values


def v2_page(num_values, itemsize=8, value=0, values=None, encoding=0,
            num_nulls=0, def_len=0, rep_len=0, levels=b''):
    """One handwritten DATA_PAGE_V2 (thrift compact header + body). The body
    is ``levels + values`` — v2 keeps the def/rep level blocks as an
    uncompressed prefix with explicit byte lengths (fields 5/6), and field 7
    (is_compressed) is written FALSE so the builder needs no codec."""
    if values is None:
        values = struct.pack('<q', value)[:itemsize] * num_values
    body = levels + values
    dph2 = (bytes([0x15]) + tzigzag(num_values)   # 1: num_values
            + bytes([0x15]) + tzigzag(num_nulls)  # 2: num_nulls
            + bytes([0x15]) + tzigzag(num_values)  # 3: num_rows
            + bytes([0x15]) + tzigzag(encoding)   # 4: encoding
            + bytes([0x15]) + tzigzag(def_len)    # 5: def-levels byte length
            + bytes([0x15]) + tzigzag(rep_len)    # 6: rep-levels byte length
            + bytes([0x12])                        # 7: is_compressed = FALSE
            + b'\x00')
    header = (bytes([0x15]) + tzigzag(3)               # 1: type DATA_PAGE_V2
              + bytes([0x15]) + tzigzag(len(body))     # 2: uncompressed
              + bytes([0x15]) + tzigzag(len(body))     # 3: compressed
              + bytes([0x5C]) + dph2                   # 8: DataPageHeaderV2
              + b'\x00')
    return header + body


def v2_overdeclared_levels_chunk():
    """A corrupt v2 page whose declared def-levels length exceeds the whole
    page body: skipping it blindly would read past the chunk. Must be
    rejected at scan time (def-levels status), never dereferenced."""
    return v2_page(4, def_len=1 << 20)


def dict_page(num_values, values):
    """One handwritten v1 DICTIONARY page declaring ``num_values`` entries."""
    header = (bytes([0x15]) + tzigzag(2)              # 1: type DICTIONARY_PAGE
              + bytes([0x15]) + tzigzag(len(values))  # 2: uncompressed
              + bytes([0x15]) + tzigzag(len(values))  # 3: compressed
              + bytes([0x4C])                         # 7: DictionaryPageHeader
              + bytes([0x15]) + tzigzag(num_values)   # 1: num_values
              + bytes([0x15]) + tzigzag(0)            # 2: encoding PLAIN
              + b'\x00'
              + b'\x00')
    return header + values


def overflow_dict_chunk():
    """The PR 6 regression: a dictionary page declaring ``2**61`` entries
    over ONE real 8-byte value, indexed far out of range — the
    multiplication-form bounds product used to wrap to 0 and pass."""
    dict_vals = struct.pack('<q', 42)
    idx = bytes([8]) + tvarint(4 << 1) + bytes([200])  # RLE run: 4 x index 200
    return dict_page(1 << 61, dict_vals) + plain_page(4, values=idx, encoding=2)


def map_of_bools_stats(count=1 << 62):
    """A ``Statistics`` struct holding an unknown field 7: a map of bools to
    bools declaring ``count`` entries. Each bool of a compact-protocol map
    takes one byte, so skipping it must consume ``count`` pairs of bytes and
    run off the chunk; a skipper that consumes none spins."""
    return bytes([0x7B]) + tvarint(count) + bytes([0x11]) + b'\x00'


def map_of_bools_page():
    """One v1 data page whose statistics hold :func:`map_of_bools_stats`:
    the page scan and the fused read must reject it, and return."""
    return plain_page(4, stats=map_of_bools_stats())

# ---------------------------------------------------------------------------
# handwritten zstd / lz4 frames (PR 15): the first-party decompressors are
# driven with frames no real encoder emits — truncations, over-declared
# content sizes, corrupt compressed blocks — plus byte-exact positive
# controls built from raw/RLE blocks only (no entropy coding needed).
# ---------------------------------------------------------------------------

ZSTD_MAGIC = 0xFD2FB528
LZ4_FRAME_MAGIC = 0x184D2204


def zstd_frame_bytes(payload, content_size=None, block_kind='raw'):
    """One handwritten RFC 8878 frame: single-segment header with a 4-byte
    frame-content-size, then ONE block. ``block_kind``:

    * ``'raw'`` — a stored block carrying ``payload`` verbatim;
    * ``'rle'`` — an RLE block regenerating ``len(payload)`` copies of
      ``payload[0]``;
    * ``'corrupt'`` — a block flagged COMPRESSED whose body is ``payload``
      (garbage to the FSE/huffman parsers: must be rejected, never decoded).

    ``content_size`` overrides the declared frame content size (over- or
    under-declaring what the block regenerates)."""
    if content_size is None:
        content_size = len(payload)
    fhd = (2 << 6) | 0x20  # fcs_code 2 (4-byte FCS) + single-segment
    out = struct.pack('<I', ZSTD_MAGIC) + bytes([fhd]) + struct.pack(
        '<I', content_size)
    if block_kind == 'raw':
        bh = (len(payload) << 3) | 1                  # type 0 (raw), last
        out += struct.pack('<I', bh)[:3] + payload
    elif block_kind == 'rle':
        bh = (len(payload) << 3) | (1 << 1) | 1       # type 1 (RLE), last
        out += struct.pack('<I', bh)[:3] + payload[:1]
    else:
        bh = (len(payload) << 3) | (2 << 1) | 1       # type 2 (compressed)
        out += struct.pack('<I', bh)[:3] + payload
    return out


def lz4_raw_block_bytes(payload):
    """One raw LZ4 block holding ``payload`` as a single literals-only final
    sequence (valid per spec: the last sequence carries no match)."""
    lit = len(payload)
    out = bytearray([min(lit, 15) << 4])
    if lit >= 15:
        rem = lit - 15
        while rem >= 255:
            out.append(255)
            rem -= 255
        out.append(rem)
    return bytes(out) + payload


def lz4_raw_match_block():
    """A raw LZ4 block exercising the overlapping match-copy path: 4
    literals, a match of 8 at offset 4 (self-overlapping), then a
    literals-only tail. Returns ``(block_bytes, decoded_bytes)``."""
    block = (bytes([(4 << 4) | (8 - 4)]) + b'abcd' + struct.pack('<H', 4)
             + bytes([2 << 4]) + b'zz')
    return block, b'abcd' * 3 + b'zz'


def lz4_frame_bytes(payload, stored=False):
    """One handwritten LZ4 frame (magic, FLG/BD/HC, one block, EndMark).
    ``stored=True`` writes the block uncompressed (high bit of the size)."""
    flg = (1 << 6) | 0x20  # version 01, block-independent
    out = struct.pack('<I', LZ4_FRAME_MAGIC) + bytes([flg, 0x40, 0])
    block = payload if stored else lz4_raw_block_bytes(payload)
    bsz = len(block) | (0x80000000 if stored else 0)
    return out + struct.pack('<I', bsz) + block + struct.pack('<I', 0)


def lz4_hadoop_bytes(payload, declared_raw=None):
    """One hadoop-framed LZ4 chunk (what parquet's legacy LZ4 codec writes):
    big-endian [decompressed size][compressed size] then a raw block.
    ``declared_raw`` over/under-declares the decompressed size."""
    block = lz4_raw_block_bytes(payload)
    want = len(payload) if declared_raw is None else declared_raw
    return struct.pack('>II', want, len(block)) + block


def compressed_frame_corpus():
    """(chunk_bytes, codec, expect_ok) triples: handwritten compressed pages
    driven through the fused kernel — positive controls that MUST decode
    byte-exactly, and malformed frames that MUST be rejected with a status.
    Replayed by the release fuzz lane and the ASan/UBSan lane alike."""
    vals = struct.pack('<qqqq', 7, 7, 7, 7)
    # an RLE block regenerates payload[0] x declared-size, so its positive
    # control uses a byte-uniform payload that IS its own regeneration
    rle_vals = b'\x07' * 32
    return [
        # -- positive controls (expect_ok=True, output must equal expect bytes)
        (plain_page(4, values=zstd_frame_bytes(vals), declared_raw=32), 2, True, vals),
        (plain_page(4, values=zstd_frame_bytes(rle_vals, block_kind='rle'),
                    declared_raw=32), 2, True, rle_vals),
        (plain_page(4, values=lz4_raw_block_bytes(vals), declared_raw=32), 3, True, vals),
        (plain_page(4, values=lz4_frame_bytes(vals), declared_raw=32), 4, True, vals),
        (plain_page(4, values=lz4_frame_bytes(vals, stored=True),
                    declared_raw=32), 4, True, vals),
        (plain_page(4, values=lz4_hadoop_bytes(vals), declared_raw=32), 4, True, vals),
        # -- truncated frames: every prefix check must hold
        (plain_page(4, values=zstd_frame_bytes(vals)[:11], declared_raw=32), 2, False, vals),
        (plain_page(4, values=lz4_raw_block_bytes(vals)[:3], declared_raw=32), 3, False, vals),
        (plain_page(4, values=lz4_hadoop_bytes(vals)[:7], declared_raw=32), 4, False, vals),
        # -- over-declared sizes: the declared regeneration exceeds reality
        (plain_page(4, values=zstd_frame_bytes(vals, content_size=1 << 20),
                    declared_raw=32), 2, False, vals),
        (plain_page(4, values=lz4_hadoop_bytes(vals, declared_raw=1 << 20),
                    declared_raw=32), 4, False, vals),
        # -- under-declared: frame regenerates more than the page claims
        (plain_page(4, values=zstd_frame_bytes(vals * 2, content_size=16),
                    declared_raw=32), 2, False, vals),
        # -- corrupt compressed block: garbage to the FSE/huffman parsers
        (plain_page(4, values=zstd_frame_bytes(b'\x9e\x42' * 8,
                                               block_kind='corrupt'),
                    declared_raw=32), 2, False, vals),
        # -- codec mismatch: a valid zstd frame fed to the lz4 decoder
        (plain_page(4, values=zstd_frame_bytes(vals), declared_raw=32), 3, False, vals),
    ]


def page_stats_corpus():
    """Pages with handwritten min/max Statistics, valid and corrupt — the
    page-stat parser must bounds-check declared binary lengths."""
    vals = struct.pack('<qqqq', 1, 2, 3, 4)
    lo, hi = struct.pack('<q', 1), struct.pack('<q', 4)
    return [
        # valid stats: page decodes, stats parse
        (plain_page(4, values=vals,
                    stats=stats_struct(min_value=lo, max_value=hi,
                                       null_count=0)), True),
        # over-declared binary length: must be rejected at header-parse time,
        # never read past the chunk
        (plain_page(4, values=vals,
                    stats=stats_struct(min_value=lo, max_value=hi,
                                       max_len=1 << 20)), False),
        (plain_page(4, values=vals,
                    stats=stats_struct(min_value=lo, min_len=1 << 20)), False),
        # stats struct with only a null count (min/max absent): decodes fine,
        # the skip logic must simply distrust the page
        (plain_page(4, values=vals, stats=stats_struct(null_count=2)), True),
    ]


def fuzz_corpus(seed=0xF05ED, mutated=150, garbage=60, max_garbage=96):
    """The seeded corpus the release fuzz test replays: byte mutations /
    truncations / splices of a valid two-page chunk, then pure garbage.
    Yields ``bytes`` (deterministic for a given seed)."""
    rng = np.random.default_rng(seed)
    # v1 + v2 pages in the base chunk: mutations/truncations exercise both
    # header parsers (and the v2 level-skip arithmetic) under the sanitizers
    valid = bytearray(plain_page(4) * 2 + v2_page(4))
    for _ in range(mutated):
        data = bytearray(valid)
        for _ in range(rng.integers(1, 8)):
            op = rng.integers(0, 3)
            if op == 0 and len(data) > 1:           # mutate
                data[rng.integers(0, len(data))] = rng.integers(0, 256)
            elif op == 1 and len(data) > 2:         # truncate
                del data[int(rng.integers(1, len(data))):]
            else:                                    # splice random bytes
                data += bytes(rng.integers(0, 256, rng.integers(1, 32),
                                           dtype=np.uint8))
        yield bytes(data)
    for _ in range(garbage):
        yield bytes(rng.integers(0, 256, rng.integers(0, max_garbage),
                                 dtype=np.uint8))


def replay_chunk_through_kernels(lib, data, reason_by_status):
    """Drive one corpus entry through every parser at the native boundary:
    the plain-page scanner (both def-level modes) and the fused kernel in
    every mode x codec combination. Raises AssertionError when a kernel
    breaks the sentinel contract; under sanitizers an over-read aborts the
    process before any assertion fires."""
    from petastorm_tpu_torch.native import fused

    chunk = np.frombuffer(bytes(data), dtype=np.uint8) if len(data) else \
        np.zeros(1, np.uint8)[:0]
    offs = (ctypes.c_ulonglong * 16)()
    counts = (ctypes.c_longlong * 16)()
    vlens = (ctypes.c_ulonglong * 16)()
    for has_def in (0, 1):
        n = lib.pstpu_scan_plain_pages(
            chunk.ctypes.data_as(ctypes.c_void_p), chunk.size, offs, counts,
            vlens, 16, has_def)
        assert -1 <= n <= 16, n
    if chunk.size == 0:
        return
    # every mode x codec the dispatch accepts: UNCOMPRESSED, SNAPPY, ZSTD,
    # LZ4_RAW and auto-detected LZ4 all walk the same page/decompress path
    for mode in (0, 1):
        for codec in (0, 1, 2, 3, 4):
            plan = fused.ColumnPlan('f')
            plan.mode = mode
            plan.codec = codec
            plan.itemsize = 8
            plan.strip_npy = mode == 1
            plan.out_dtype = np.dtype(np.int64)
            plan.out_shape = (4,)
            plan.chunk_len = chunk.size
            plan.out_bound = 64
            out = np.zeros(64, np.uint8)
            (res,) = fused.read_into(lib, [chunk], [plan], 4, out, [0])
            assert res[0] in reason_by_status or res[0] == 0, res
    replay_chunk_through_pred_kernel(lib, chunk)


def _pred_plan_for_chunk(fused, chunk, codec):
    plan = fused.ColumnPlan('f')
    plan.mode = 0
    plan.codec = codec
    plan.itemsize = 8
    plan.phys_dtype = np.dtype(np.int64)
    plan.out_dtype = np.dtype(np.int64)
    plan.out_shape = (4,)
    plan.chunk_len = chunk.size
    plan.out_bound = 64
    plan.known_size = True
    return plan


def replay_chunk_through_pred_kernel(lib, chunk):
    """Drive one chunk through the fused *predicate* entry point: the chunk
    serves as both the output column and the predicate column, under an IN
    clause and a negated RANGE clause. The kernel must honour the same
    sentinel contract as the unfiltered pass — a selection bitmap and status,
    never a crash or over-read (the ASan lane replays this identically)."""
    from petastorm_tpu_torch.native import fused

    operand = np.arange(2, dtype=np.int64).view(np.uint8)
    bound = np.zeros(16, dtype=np.uint8)
    for codec in (0, 1, 2, 3, 4):
        plan = _pred_plan_for_chunk(fused, chunk, codec)
        pred_plan = _pred_plan_for_chunk(fused, chunk, codec)
        for op, negate in ((fused.PRED_IN, 0), (fused.PRED_RANGE, 1)):
            preds = (fused.FusedPredStruct * 1)()
            pr = preds[0]
            if op == fused.PRED_IN:
                pr.values = operand.ctypes.data
                pr.values_cap = operand.nbytes
                pr.count = 2
            else:
                pr.values = bound.ctypes.data
                pr.values_cap = bound.nbytes
                pr.count = 0
                pr.has_lo = 1
                pr.lo_incl = 1
            pr.col = 0
            pr.op = op
            pr.dtype = 1  # i64
            pr.negate = negate
            plan_obj = fused.FusedPlan([plan], [], {}, 4)
            res = fused.read_block_pred(lib, [chunk], plan_obj, [chunk],
                                        [pred_plan], preds,
                                        [operand, bound])
            if res is not None:
                _block, _reasons, sel_mask, n_selected, _skipped = res
                assert 0 <= n_selected <= 4
                assert int(sel_mask.sum()) == n_selected, (n_selected, sel_mask)


def replay_corrupt_chunk_regressions(lib):
    """The handwritten corrupt-chunk regressions (the shipped PR 6 bug
    class), asserting each is rejected with the expected status."""
    from petastorm_tpu_torch.native import fused

    chunk = np.frombuffer(overflow_dict_chunk(), dtype=np.uint8)
    plan = fused.ColumnPlan('x')
    plan.itemsize = 8
    plan.phys_dtype = np.dtype(np.int64)
    plan.out_dtype = np.dtype(np.int64)
    plan.out_shape = (4,)
    plan.chunk_len = chunk.size
    plan.out_bound = 4 * 8
    out = np.zeros(32, np.uint8)
    (res,) = fused.read_into(lib, [chunk], [plan], 4, out, [0])
    assert res[0] == 9, res  # kColDict: rejected, never dereferenced

    # v2 page declaring a def-levels block longer than its whole body: the
    # level skip must be bounds-checked, not trusted
    chunk_v2 = np.frombuffer(v2_overdeclared_levels_chunk(), dtype=np.uint8)
    plan_v2 = fused.ColumnPlan('v2')
    plan_v2.itemsize = 8
    plan_v2.phys_dtype = np.dtype(np.int64)
    plan_v2.out_dtype = np.dtype(np.int64)
    plan_v2.out_shape = (4,)
    plan_v2.chunk_len = chunk_v2.size
    plan_v2.out_bound = 4 * 8
    out_v2 = np.zeros(32, np.uint8)
    (res_v2,) = fused.read_into(lib, [chunk_v2], [plan_v2], 4, out_v2, [0])
    assert res_v2[0] == 5, res_v2  # kColDefLevels: rejected, never skipped-past

    # stale-metadata precheck: a failing column must not shift its
    # neighbors' aux buffers (the aux_bufs index-misalignment regression)
    import io
    cells = []
    for i in range(2):
        buf = io.BytesIO()
        np.save(buf, np.arange(3, dtype=np.int64) + i)
        cells.append(buf.getvalue())
    values = b''.join(struct.pack('<I', len(c)) + c for c in cells)
    chunk2 = np.frombuffer(plain_page(2, values=values), dtype=np.uint8)
    payload = 3 * 8
    bad = fused.ColumnPlan('bad')
    bad.chunk_len = chunk2.size + 1
    bad.out_bound = 16
    good = fused.ColumnPlan('good')
    good.mode = fused.MODE_BINARY_RAW
    good.strip_npy = True
    good.chunk_len = chunk2.size
    good.out_bound = 2 * payload
    out2 = np.zeros(16 + 2 * payload, np.uint8)
    res2 = fused.read_into(lib, [chunk2, chunk2], [bad, good], 2, out2, [0, 16])
    assert res2[0][0] != 0 and res2[1][0] == 0, res2
    assert res2[1][3] > 0 and res2[1][4] == cells[0][:res2[1][3]], res2

    replay_map_of_bools(lib)
    replay_compressed_frames(lib)
    replay_page_stats(lib)


def replay_map_of_bools(lib):
    """The map of bools (:func:`map_of_bools_page`) through the page scan
    in both def-level modes and through the fused read: refused, and the
    calls return."""
    from petastorm_tpu_torch.native import fused

    chunk = np.frombuffer(map_of_bools_page(), dtype=np.uint8)
    out = [(ctypes.c_ulonglong * 16)(), (ctypes.c_longlong * 16)(), (ctypes.c_ulonglong * 16)()]
    for has_def in (0, 1):
        n = lib.pstpu_scan_plain_pages(chunk.ctypes.data_as(ctypes.c_void_p), chunk.size,
                                       *out, 16, has_def)
        assert n == -1, n
    plan = fused.ColumnPlan('m')
    plan.itemsize = 8
    plan.phys_dtype = np.dtype(np.int64)
    plan.out_dtype = np.dtype(np.int64)
    plan.out_shape = (4,)
    plan.chunk_len = chunk.size
    plan.out_bound = 32
    (res,) = fused.read_into(lib, [chunk], [plan], 4, np.zeros(32, np.uint8), [0])
    assert res[0] != 0, res


def replay_compressed_frames(lib):
    """Handwritten zstd/lz4 frames through the fused kernel: positive
    controls must decode byte-exactly, malformed frames must be rejected
    with a status — never a crash or over-read."""
    from petastorm_tpu_torch.native import fused

    for data, codec, expect_ok, vals in compressed_frame_corpus():
        chunk = np.frombuffer(data, dtype=np.uint8)
        plan = fused.ColumnPlan('c')
        plan.codec = codec
        plan.itemsize = 8
        plan.phys_dtype = np.dtype(np.int64)
        plan.out_dtype = np.dtype(np.int64)
        plan.out_shape = (4,)
        plan.chunk_len = chunk.size
        plan.out_bound = len(vals)
        out = np.zeros(len(vals), np.uint8)
        (res,) = fused.read_into(lib, [chunk], [plan], 4, out, [0])
        if expect_ok:
            assert res[0] == 0, (res, codec)
            assert bytes(out) == vals, (codec, bytes(out))
        else:
            assert res[0] != 0, (res, codec)


def replay_page_stats(lib):
    """Pages carrying handwritten Statistics structs: valid stats must not
    disturb the decode, over-declared binary lengths must be rejected at
    header-parse time."""
    from petastorm_tpu_torch.native import fused

    for data, expect_ok in page_stats_corpus():
        chunk = np.frombuffer(data, dtype=np.uint8)
        plan = fused.ColumnPlan('s')
        plan.itemsize = 8
        plan.phys_dtype = np.dtype(np.int64)
        plan.out_dtype = np.dtype(np.int64)
        plan.out_shape = (4,)
        plan.chunk_len = chunk.size
        plan.out_bound = 32
        out = np.zeros(32, np.uint8)
        (res,) = fused.read_into(lib, [chunk], [plan], 4, out, [0])
        if expect_ok:
            assert res[0] == 0, res
        else:
            assert res[0] != 0, res


def _read(ring):
    """One message of ``ring`` as bytes, or None when it is empty."""
    view = ring.try_read_view()
    return None if view is None else bytes(view)


def replay_ring_cycles(ring_mod, name_suffix):
    """Reserve/commit/abort + pad-marker wrap cycles and the never-fit
    reservation through a (possibly sanitized) shm ring build."""
    ring = ring_mod.ShmRing.create('/pstpu_torch_san_{}'.format(name_suffix), 4096)
    try:
        for i in range(60):
            payload = bytes([i % 251]) * (i * 37 % 900 + 10)
            mv = ring.try_reserve(len(payload))
            assert mv is not None
            mv[:len(payload)] = payload
            ring.commit(len(payload))
            assert _read(ring) == payload
        ring.try_reserve(100)
        ring.abort()
        assert _read(ring) is None
        assert ring.try_write(b'x' * 1992) and _read(ring) is not None
        try:
            ring.try_reserve(3000)  # wrap pad + header + payload can never fit
        except ValueError:
            pass
        else:
            raise AssertionError('never-fit reservation did not raise')
    finally:
        ring.close()


def replay_lifetime_cycles(ring_mod, name_suffix):
    """Zero-copy peek/release cycles through a (possibly sanitized) shm ring
    build: borrowed in-place views, wrapped-message copies, out-of-order
    consumer releases retired FIFO by the ledger, peek-aware ``has_message``
    probes, and the drain-deferred close. Every byte of every borrowed view
    is read back while live — under ASan an over-read of the mapped data
    area aborts the replay."""
    from petastorm_tpu_torch.native.lifetime import RingBorrowLedger, SlotRegistry

    ring = ring_mod.ShmRing.create('/pstpu_torch_lt_{}'.format(name_suffix), 8192)
    registry = SlotRegistry()
    try:
        ledger = RingBorrowLedger(ring, registry_=registry)
        for round_no in range(40):
            payloads = [bytes([(round_no + i) % 251]) * (i * 53 % 900 + 16)
                        for i in range(4)]
            for p in payloads:
                assert ring.try_write(p)
            taken = []
            while True:
                item = ring.try_read_zero_copy()
                if item is None:
                    break
                view, span, borrowed = item
                slot = ledger.take(view, span, borrowed)
                taken.append((bytes(view), slot))  # full read of the view
            assert [p for p, _ in taken] == payloads
            assert not ring.has_message()  # peeked past: nothing pending
            # rotate the release order per round; the ledger must retire
            # spans FIFO regardless
            order = [(i + round_no) % len(taken) for i in range(len(taken))]
            for i in order:
                taken[i][1].release_now()
            assert ledger.live == 0
        assert registry.counters()['lifetime_live_borrows'] == 0
        # deferred close: a live borrow blocks the munmap until it dies
        assert ring.try_write(b'q' * 64)
        view, span, borrowed = ring.try_read_zero_copy()
        slot = ledger.take(view, span, borrowed)
        closed = []
        assert not ledger.close_when_drained(lambda: closed.append(1))
        slot.release_now()
        assert closed == [1]
    finally:
        ring.close()  # idempotent: the drained ledger may have closed it


# ---------------------------------------------------------------------------
# PNG cells for the batched image decoder (native/image_codec.cpp)
# ---------------------------------------------------------------------------

def _png_chunk(kind, data):
    return len(data).to_bytes(4, 'big') + kind + data + zlib.crc32(kind + data).to_bytes(4, 'big')


def png_bytes(img, ihdr_shape=None):
    """A non-interlaced 8- or 16-bit gray or RGB PNG of ``img``, its rows
    filtered None, Sub, Up, Average and Paeth in turn, so a decode runs every
    unfilter. ``ihdr_shape=(h, w)`` over-declares the header's dims."""
    h, w = img.shape[:2]
    channels = 1 if img.ndim == 2 else img.shape[2]
    depth = img.dtype.itemsize * 8
    raw = np.ascontiguousarray(img, dtype='>u2' if depth == 16 else np.uint8)
    raw = raw.reshape(h, -1).view(np.uint8).astype(np.int32)
    bpp = channels * depth // 8
    left = np.zeros_like(raw)
    left[:, bpp:] = raw[:, :-bpp]
    up = np.zeros_like(raw)
    up[1:] = raw[:-1]
    upleft = np.zeros_like(raw)
    upleft[1:, bpp:] = raw[:-1, :-bpp]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    predictors = [np.zeros_like(raw), left, up, (left + up) // 2, paeth]
    rows = [bytes([y % 5]) + ((raw[y] - predictors[y % 5][y]) % 256).astype(np.uint8).tobytes()
            for y in range(h)]
    hh, ww = ihdr_shape or (h, w)
    ihdr = (ww.to_bytes(4, 'big') + hh.to_bytes(4, 'big')
            + bytes([depth, 0 if channels == 1 else 2, 0, 0, 0]))
    return (b'\x89PNG\r\n\x1a\n' + _png_chunk(b'IHDR', ihdr)
            + _png_chunk(b'IDAT', zlib.compress(b''.join(rows))) + _png_chunk(b'IEND', b''))


def png_corpus(seed=0x1A6E):
    """``(cell, expected)`` pairs: valid PNGs (gray and RGB, 8 and 16 bit)
    with the image they hold, and malformed cells (truncated at every
    section, a corrupt IDAT, dims over-declared past the data, garbage) with
    ``expected`` None: the decoder must refuse them with an error, never
    crash or over-read."""
    rng = np.random.default_rng(seed)
    out = []
    for shape, dtype in (((13, 17), np.uint8), ((9, 11, 3), np.uint8),
                         ((7, 5), np.uint16), ((6, 10, 3), np.uint16)):
        img = rng.integers(0, np.iinfo(dtype).max, shape, dtype=dtype, endpoint=True)
        out.append((png_bytes(img), img))
    img = rng.integers(0, 256, (12, 12, 3), dtype=np.uint8)
    cell = png_bytes(img)
    for cut in (8, 20, 33, len(cell) // 2, len(cell) - 13):
        out.append((cell[:cut], None))
    idat = cell.index(b'IDAT') + 4
    spoiled = bytearray(cell)
    spoiled[idat + 2:idat + 10] = bytes(8)
    out.append((bytes(spoiled), None))
    out.append((png_bytes(img, ihdr_shape=(48, 12)), None))
    out.append((png_bytes(img, ihdr_shape=(12, 40)), None))
    for n in (0, 7, 64):
        out.append((b'\x89PNG\r\n\x1a\n' + bytes(rng.integers(0, 256, n, dtype=np.uint8)), None))
    return out


def replay_image_decodes(image_codec):
    """:func:`png_corpus` through the decoder of ``image_codec`` (the port's
    ``native/image_codec.py``, bound to a release or sanitized build), one
    cell at a time and as one batch of the valid cells, then each resize
    entry point over the decoded RGB image: valid cells decode exactly,
    malformed ones raise ``NativeDecodeError``. Returns the cells replayed."""
    corpus = png_corpus()
    for cell, expected in corpus:
        if expected is None:
            try:
                image_codec.decode_images([cell])
            except image_codec.NativeDecodeError:
                continue
            raise AssertionError('malformed PNG cell of {} bytes decoded'.format(len(cell)))
        (got,) = image_codec.decode_images([cell])
        np.testing.assert_array_equal(got, expected)
    valid = [(cell, img) for cell, img in corpus if img is not None]
    for got, (_, img) in zip(image_codec.decode_images([c for c, _ in valid], threads=2), valid):
        np.testing.assert_array_equal(got, img)
    rgb = next(img for _, img in valid if img.ndim == 3 and img.dtype == np.uint8)
    for resize in (image_codec.resize_area_image, image_codec.resize_bilinear_image):
        for size in ((4, 5), (20, 23)):
            out = resize(rgb, size)
            assert out.shape[:2] == size, out.shape
    return len(corpus)


# ---------------------------------------------------------------------------
# the whole replay, as the sanitizer lane runs it
# ---------------------------------------------------------------------------

def replay_all(name_suffix=None):
    """Build the port's three libraries (sanitized under ``PSTPU_SANITIZE``)
    and replay the whole corpus through them: the fuzz corpus, the corrupt
    chunk regressions (the map of bools, the compressed frames and the page
    statistics among them), the PNG cells and resizes, and the ring and
    lifetime cycles. Returns ``{'build_s': {...}, 'replay_s': s, 'items':
    {...}, 'libraries': {...}}``. Raises AssertionError on a broken contract;
    under the sanitizers a finding aborts the process first."""
    import concurrent.futures
    import os
    import time

    from petastorm_tpu_torch import native
    from petastorm_tpu_torch.native import build, fused, image_codec, shm_ring

    suffix = name_suffix or str(os.getpid())
    build_s, libraries = {}, {}

    def timed_build(name, fn):
        t0 = time.perf_counter()
        libraries[name] = fn()
        build_s[name] = time.perf_counter() - t0

    # one g++ per library, all at once
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        for done in [pool.submit(timed_build, name, fn) for name, fn in (
                ('reader', build.build), ('image', build.build_img), ('ring', build.build_ring))]:
            done.result()
    t0 = time.perf_counter()
    lib = native._load_library()
    assert lib is not None, 'the reader library did not load'
    items = {'fuzz': 0}
    for data in fuzz_corpus():
        replay_chunk_through_kernels(lib, data, fused.REASON_BY_STATUS)
        items['fuzz'] += 1
    replay_corrupt_chunk_regressions(lib)
    items['regressions'] = 4 + len(compressed_frame_corpus()) + len(page_stats_corpus())
    assert image_codec.is_available(), 'the image codec did not load'
    items['png'] = replay_image_decodes(image_codec)
    assert shm_ring.is_available(), 'the shm ring did not load'
    replay_ring_cycles(shm_ring, suffix)
    replay_lifetime_cycles(shm_ring, suffix)
    items['ring_cycles'] = 2
    return {'build_s': build_s, 'replay_s': time.perf_counter() - t0, 'items': items,
            'libraries': libraries}


if __name__ == '__main__':
    # python -m petastorm_tpu_torch.test_util.native_corpus: one JSON line
    import json
    print(json.dumps(replay_all()), flush=True)
