"""Byte-parity of the direct raw-chunk writer against tensorstore.

The raw writer (io/raw_zarr.py) must produce chunk files whose CONTENT
is identical to tensorstore writing the same data — full-size bodies,
zero-padded edges, nested keys — because downstream readers (tensorstore
itself, napari, ome-zarr consumers) see only the files.
"""

import os

import numpy as np
import pytest

from image_stitcher_tpu.io.raw_zarr import RawV2SlabWriter
from image_stitcher_tpu.io.zarr_store import (create_zarr_array,
                                               open_zarr_array)
from image_stitcher_tpu.native import get_lib

pytestmark = pytest.mark.skipif(
    get_lib() is None or not hasattr(get_lib(), 'write_rows_contig'),
    reason="native hostops unavailable")


def _all_chunk_files(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            if f.startswith('.'):
                continue
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = p
    return out


def _write_both(tmp_path, shape, chunks, dtype, slabs):
    """slabs: list of (sel, data). Returns (ts_dir, raw_dir)."""
    ts_dir = str(tmp_path / 'ts')
    raw_dir = str(tmp_path / 'raw')
    arr = create_zarr_array(ts_dir, shape, chunks, dtype, cname=None)
    create_zarr_array(raw_dir, shape, chunks, dtype, cname=None)
    raw = RawV2SlabWriter(raw_dir, shape, chunks, dtype)
    assert raw.ok
    for sel, data in slabs:
        arr[sel].write(data).result() if sel is not None \
            else arr.write(data).result()
        assert raw.try_write(sel, data)
    return ts_dir, raw_dir


def _assert_file_parity(ts_dir, raw_dir):
    ts_files = _all_chunk_files(ts_dir)
    raw_files = _all_chunk_files(raw_dir)
    assert set(ts_files) == set(raw_files)
    for rel in ts_files:
        a = open(ts_files[rel], 'rb').read()
        b = open(raw_files[rel], 'rb').read()
        assert a == b, f"chunk {rel} differs"


@pytest.mark.parametrize("dtype", [np.uint16, np.uint8])
def test_band_slabs_match_tensorstore(tmp_path, dtype):
    rng = np.random.default_rng(0)
    shape = (1, 2, 1, 300, 500)          # edge chunks in y and x
    chunks = (1, 1, 1, 128, 128)
    slabs = []
    for c in range(2):
        for y0 in (0, 128, 256):         # bands aligned to the chunk grid
            h = min(128, 300 - y0)
            data = rng.integers(0, np.iinfo(dtype).max, (h, 500), dtype)
            sel = (slice(0, 1), slice(c, c + 1), slice(0, 1),
                   slice(y0, y0 + h), slice(0, 500))
            slabs.append((sel, data[None, None, None]))
    _assert_file_parity(*_write_both(tmp_path, shape, chunks, dtype, slabs))


def test_partial_chunk_rows_match(tmp_path):
    """Pyramid-style writes: bands cover a fraction of a chunk's rows,
    two bands land in the same chunk file."""
    rng = np.random.default_rng(1)
    shape = (1, 1, 1, 200, 130)
    chunks = (1, 1, 1, 128, 64)
    slabs = []
    for y0, h in ((0, 50), (50, 78), (128, 72)):
        data = rng.integers(0, 65535, (h, 130), np.uint16)
        sel = (slice(0, 1), slice(0, 1), slice(0, 1),
               slice(y0, y0 + h), slice(0, 130))
        slabs.append((sel, data[None, None, None]))
    _assert_file_parity(*_write_both(tmp_path, shape, chunks,
                                     np.uint16, slabs))


def test_narrow_level_width_leaves_tail_chunks_missing(tmp_path):
    """A write narrower than the array (pyramid w_lv < shape) pads the
    touched chunk and leaves wholly-uncovered chunks as fill."""
    shape = (1, 1, 1, 64, 300)
    chunks = (1, 1, 1, 64, 64)
    raw_dir = str(tmp_path / 'raw')
    create_zarr_array(raw_dir, shape, chunks, np.uint16, cname=None)
    raw = RawV2SlabWriter(raw_dir, shape, chunks, np.uint16)
    data = np.full((1, 1, 1, 64, 100), 7, np.uint16)
    sel = (slice(0, 1), slice(0, 1), slice(0, 1), slice(0, 64),
           slice(0, 100))
    assert raw.try_write(sel, data)
    files = _all_chunk_files(raw_dir)
    assert set(files) == {os.path.join('0', '0', '0', '0', '0'),
                          os.path.join('0', '0', '0', '0', '1')}
    import tensorstore as ts
    a = ts.open({"driver": "zarr",
                 "kvstore": {"driver": "file", "path": raw_dir}}).result()
    back = a.read().result()
    assert (back[0, 0, 0, :, :100] == 7).all()
    assert (back[0, 0, 0, :, 100:] == 0).all()


def test_unsupported_patterns_fall_back(tmp_path):
    raw_dir = str(tmp_path / 'raw')
    shape = (1, 1, 1, 128, 128)
    chunks = (1, 1, 1, 64, 64)
    create_zarr_array(raw_dir, shape, chunks, np.uint16, cname=None)
    raw = RawV2SlabWriter(raw_dir, shape, chunks, np.uint16)
    data = np.zeros((1, 1, 1, 64, 64), np.uint16)
    # x not starting at 0
    sel = (slice(0, 1), slice(0, 1), slice(0, 1), slice(0, 64),
           slice(64, 128))
    assert not raw.try_write(sel, data)
    # dtype mismatch
    sel0 = (slice(0, 1), slice(0, 1), slice(0, 1), slice(0, 64),
            slice(0, 64))
    assert not raw.try_write(sel0, data.astype(np.uint8))
    # shape mismatch vs sel
    assert not raw.try_write(sel0, np.zeros((1, 1, 1, 32, 64), np.uint16))
    # non-zero fill refuses at construction
    assert not RawV2SlabWriter(raw_dir, shape, chunks, np.uint16,
                               fill_value=3).ok


def test_full_level_write_matches(tmp_path):
    """sel=None whole-array writes (in-RAM save path) round-trip."""
    rng = np.random.default_rng(2)
    shape = (1, 2, 2, 100, 90)
    chunks = (1, 1, 1, 64, 64)
    data = rng.integers(0, 65535, shape, np.uint16)
    _assert_file_parity(*_write_both(tmp_path, shape, chunks, np.uint16,
                                     [(None, data)]))


def test_concurrent_band_writes_share_chunk_files(tmp_path):
    """Band threads write disjoint row ranges that land in the SAME
    pyramid chunk files concurrently (each opens its own fd; creation
    and sparse-extension race by design). The final bytes must equal a
    serial reference write."""
    import threading
    rng = np.random.default_rng(3)
    shape = (1, 1, 1, 1024, 700)
    chunks = (1, 1, 1, 256, 256)   # 4 bands of 64 rows per chunk row
    raw_dir = str(tmp_path / 'raw')
    create_zarr_array(raw_dir, shape, chunks, np.uint16, cname=None)
    raw = RawV2SlabWriter(raw_dir, shape, chunks, np.uint16)
    data = rng.integers(0, 65535, (1024, 700), np.uint16)
    bands = list(range(0, 1024, 64))
    errs = []

    def write_band(y0):
        try:
            sel = (slice(0, 1), slice(0, 1), slice(0, 1),
                   slice(y0, y0 + 64), slice(0, 700))
            assert raw.try_write(sel, data[y0:y0 + 64][None, None, None])
        except BaseException as e:  # pragma: no cover
            errs.append(e)

    for _trial in range(3):
        threads = [threading.Thread(target=write_band, args=(y0,))
                   for y0 in bands]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert not errs
    import tensorstore as ts
    a = ts.open({"driver": "zarr",
                 "kvstore": {"driver": "file", "path": raw_dir}}).result()
    assert (a.read().result()[0, 0, 0] == data).all()


# ---------------------------------------------------------------------------
# zarr v3 sharded raw writer


def _write_both_v3(tmp_path, shape, chunks, dtype, slabs,
                   shard_multiple=4, shard_multiple_y=1):
    from image_stitcher_tpu.io.raw_zarr import RawV3ShardWriter
    from image_stitcher_tpu.io.zarr_store import (
        compute_shard_shape, create_zarr3_sharded_array)
    ts_dir = str(tmp_path / 'ts3')
    raw_dir = str(tmp_path / 'raw3')
    arr = create_zarr3_sharded_array(ts_dir, shape, chunks, dtype,
                                     shard_multiple=shard_multiple,
                                     shard_multiple_y=shard_multiple_y,
                                     cname=None)
    create_zarr3_sharded_array(raw_dir, shape, chunks, dtype,
                               shard_multiple=shard_multiple,
                               shard_multiple_y=shard_multiple_y,
                               cname=None)
    cl, sh = compute_shard_shape(shape, chunks, shard_multiple,
                                 shard_multiple_y)
    raw = RawV3ShardWriter(raw_dir, shape, cl, sh, dtype)
    assert raw.ok
    for sel, data in slabs:
        (arr[sel] if sel is not None else arr).write(data).result()
        assert raw.try_write(sel, data)
    return ts_dir, raw_dir


def test_v3_crc32c_matches_tensorstore_index():
    """crc32c implementation check against a tensorstore-written shard
    is implicit in the byte-parity tests; here pin the known vector."""
    from image_stitcher_tpu.io.raw_zarr import crc32c
    assert crc32c(b'123456789') == 0xE3069283  # published CRC-32C vector


@pytest.mark.parametrize("dtype", [np.uint16, np.uint8])
def test_v3_full_cover_band_slabs_match_tensorstore(tmp_path, dtype):
    """Full-width band writes covering whole shards produce
    byte-identical shard files (bodies + index + crc)."""
    rng = np.random.default_rng(0)
    shape = (1, 2, 1, 16, 20)        # 2 shard cols (16 + 4), 4 shard rows
    chunks = (1, 1, 1, 4, 4)
    slabs = []
    for c in range(2):
        for y0 in (0, 4, 8, 12):
            data = rng.integers(0, np.iinfo(dtype).max, (4, 20), dtype)
            sel = (slice(0, 1), slice(c, c + 1), slice(0, 1),
                   slice(y0, y0 + 4), slice(0, 20))
            slabs.append((sel, data[None, None, None]))
    _assert_file_parity(*_write_both_v3(tmp_path, shape, chunks, dtype,
                                        slabs))


def test_v3_narrow_array_edge_chunk_padded(tmp_path):
    """Array width not a chunk multiple: the edge chunk body is padded
    with fill zeros, matching tensorstore bytes."""
    rng = np.random.default_rng(1)
    shape = (1, 1, 1, 4, 18)
    chunks = (1, 1, 1, 4, 4)
    data = rng.integers(0, 65535, (4, 18), np.uint16)
    sel = (slice(0, 1), slice(0, 1), slice(0, 1), slice(0, 4),
           slice(0, 18))
    _assert_file_parity(*_write_both_v3(
        tmp_path, shape, chunks, np.uint16,
        [(sel, data[None, None, None])]))


def test_v3_partial_row_writes_read_back(tmp_path):
    """Pyramid-style partial-chunk-row writes: multiple bands into the
    same shard. Tensorstore RMWs the shard; the raw writer pwrites into
    the sparse bodies. Bytes may legally differ in never-written chunks
    (present-zeros vs missing), so assert READBACK equality."""
    import tensorstore as ts
    from image_stitcher_tpu.io.raw_zarr import RawV3ShardWriter
    from image_stitcher_tpu.io.zarr_store import (
        compute_shard_shape, create_zarr3_sharded_array)
    rng = np.random.default_rng(2)
    shape = (1, 1, 1, 64, 50)
    chunks = (1, 1, 1, 16, 8)
    raw_dir = str(tmp_path / 'raw3p')
    create_zarr3_sharded_array(raw_dir, shape, chunks, np.uint16,
                               shard_multiple=4, cname=None)
    cl, sh = compute_shard_shape(shape, chunks, 4, 1)
    raw = RawV3ShardWriter(raw_dir, shape, cl, sh, np.uint16)
    assert raw.ok
    full = rng.integers(0, 65535, (64, 50), np.uint16)
    for y0, h in ((0, 6), (6, 10), (16, 30), (46, 18)):
        sel = (slice(0, 1), slice(0, 1), slice(0, 1),
               slice(y0, y0 + h), slice(0, 50))
        assert raw.try_write(sel, full[y0:y0 + h][None, None, None])
    a = ts.open({"driver": "zarr3",
                 "kvstore": {"driver": "file", "path": raw_dir}}).result()
    assert (a.read().result()[0, 0, 0] == full).all()


def test_v3_narrow_level_width_reads_fill(tmp_path):
    """A slab narrower than the array (pyramid w_lv) leaves the tail
    columns reading as fill."""
    import tensorstore as ts
    from image_stitcher_tpu.io.raw_zarr import RawV3ShardWriter
    from image_stitcher_tpu.io.zarr_store import (
        compute_shard_shape, create_zarr3_sharded_array)
    shape = (1, 1, 1, 8, 64)
    chunks = (1, 1, 1, 8, 8)
    raw_dir = str(tmp_path / 'raw3n')
    create_zarr3_sharded_array(raw_dir, shape, chunks, np.uint16,
                               shard_multiple=4, cname=None)
    cl, sh = compute_shard_shape(shape, chunks, 4, 1)
    raw = RawV3ShardWriter(raw_dir, shape, cl, sh, np.uint16)
    data = np.full((1, 1, 1, 8, 20), 9, np.uint16)
    sel = (slice(0, 1), slice(0, 1), slice(0, 1), slice(0, 8),
           slice(0, 20))
    assert raw.try_write(sel, data)
    a = ts.open({"driver": "zarr3",
                 "kvstore": {"driver": "file", "path": raw_dir}}).result()
    back = a.read().result()[0, 0, 0]
    assert (back[:, :20] == 9).all() and (back[:, 20:] == 0).all()


def test_out_of_grid_slabs_are_rejected_not_partially_written(tmp_path):
    """A slab extending past the array on ANY axis must return False
    (r3 review: a y-overrun previously KeyError'd mid-write in v3 and
    wrote stray chunk files in v2)."""
    from image_stitcher_tpu.io.raw_zarr import RawV3ShardWriter
    from image_stitcher_tpu.io.zarr_store import (
        compute_shard_shape, create_zarr3_sharded_array)
    shape = (1, 1, 1, 10, 8)
    chunks = (1, 1, 1, 4, 4)
    v2_dir = str(tmp_path / 'v2g')
    create_zarr_array(v2_dir, shape, chunks, np.uint16, cname=None)
    v2 = RawV2SlabWriter(v2_dir, shape, chunks, np.uint16)
    v3_dir = str(tmp_path / 'v3g')
    create_zarr3_sharded_array(v3_dir, shape, chunks, np.uint16,
                               shard_multiple=2, shard_multiple_y=2,
                               cname=None)
    cl, sh = compute_shard_shape(shape, chunks, 2, 2)
    v3 = RawV3ShardWriter(v3_dir, shape, cl, sh, np.uint16)
    bad_y = (slice(0, 1), slice(0, 1), slice(0, 1), slice(8, 14),
             slice(0, 8))
    data = np.zeros((1, 1, 1, 6, 8), np.uint16)
    assert not v2.try_write(bad_y, data)
    assert not v3.try_write(bad_y, data)
    bad_c = (slice(0, 1), slice(1, 2), slice(0, 1), slice(0, 4),
             slice(0, 8))
    assert not v2.try_write(bad_c, np.zeros((1, 1, 1, 4, 8), np.uint16))
    assert not v3.try_write(bad_c, np.zeros((1, 1, 1, 4, 8), np.uint16))
    assert _all_chunk_files(v2_dir) == {}
    assert set(_all_chunk_files(v3_dir)) == {'zarr.json'}  # metadata only


def test_v3_mixing_gate_disables_raw_after_fallback(tmp_path):
    """Once a v3 level takes a tensorstore fallback write, the raw
    writer must be disabled for that level — a raw write after a
    tensorstore shard repack would install a conflicting index
    (r3 review). v2 stays enabled (standalone chunk files interleave
    safely)."""
    import tensorstore as ts
    from image_stitcher_tpu.io.omezarr import MultiscaleWriter
    from image_stitcher_tpu.io.raw_zarr import RawV3ShardWriter
    rng = np.random.default_rng(4)
    out = str(tmp_path / 'gate.zarr')
    w = MultiscaleWriter(out, (1, 1, 1, 64, 64), 1, np.uint16,
                         (1, 1, 1, 16, 16), "g", 1.0, 1.0, ["c"],
                         [0xFFFFFF], cname=None, zarr_format=3,
                         shard_multiple=2)
    assert isinstance(w._raw[0], RawV3ShardWriter) and w._raw[0].ok
    full = rng.integers(0, 65535, (64, 64), np.uint16)
    # unsupported pattern (x not from 0) -> tensorstore fallback
    sel_bad = (slice(0, 1), slice(0, 1), slice(0, 1), slice(0, 64),
               slice(32, 64))
    w.write_level(0, full[:, 32:][None, None, None], sel=sel_bad)
    assert not w._raw[0].ok  # gate closed
    # subsequent supported-looking write goes through tensorstore too
    sel_ok = (slice(0, 1), slice(0, 1), slice(0, 1), slice(0, 64),
              slice(0, 32))
    w.write_level(0, full[:, :32][None, None, None], sel=sel_ok)
    w.close()
    a = ts.open({"driver": "zarr3",
                 "kvstore": {"driver": "file", "path": out + "/0"}}).result()
    assert (a.read().result()[0, 0, 0] == full).all()


def test_open_slices_accepted_like_merge_paths(tmp_path):
    """The merge paths select whole c/z axes with slice(None); the raw
    writer must accept those (it silently fell back to tensorstore for
    EVERY merge write before r3)."""
    import tensorstore as ts
    rng = np.random.default_rng(5)
    shape = (2, 2, 1, 64, 64)
    chunks = (1, 1, 1, 32, 32)
    raw_dir = str(tmp_path / 'open')
    create_zarr_array(raw_dir, shape, chunks, np.uint16, cname=None)
    raw = RawV2SlabWriter(raw_dir, shape, chunks, np.uint16)
    data = rng.integers(0, 65535, (1, 2, 1, 32, 64), np.uint16)
    sel = (slice(1, 2), slice(None), slice(None), slice(32, 64),
           slice(0, 64))
    assert raw.try_write(sel, data)
    # stepped slices stay unsupported
    sel_step = (slice(0, 1), slice(0, 2, 2), slice(0, 1),
                slice(0, 32), slice(0, 64))
    assert not raw.try_write(sel_step, data[:, :1])
    a = ts.open({"driver": "zarr",
                 "kvstore": {"driver": "file", "path": raw_dir}}).result()
    assert (a.read().result()[1, :, :, 32:, :] == data[0]).all()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fuzz_random_band_sequences_match_tensorstore(tmp_path, seed):
    """Seeded fuzz: random shapes/chunk grids/band splits through both
    writers, byte-comparing every chunk file (v2) and reading back (v3,
    where never-written in-bounds chunks legally differ present-zeros
    vs missing)."""
    import tensorstore as ts
    from image_stitcher_tpu.io.raw_zarr import RawV3ShardWriter
    from image_stitcher_tpu.io.zarr_store import (
        compute_shard_shape, create_zarr3_sharded_array)
    rng = np.random.default_rng(100 + seed)
    dtype = [np.uint16, np.uint8][seed % 2]
    c = int(rng.integers(1, 3))
    h = int(rng.integers(40, 300))
    w = int(rng.integers(40, 300))
    cy = int(rng.integers(8, 80))
    cx = int(rng.integers(8, 80))
    shape = (1, c, 1, h, w)
    chunks = (1, 1, 1, cy, cx)
    full = rng.integers(0, np.iinfo(dtype).max, (c, h, w), dtype)
    # random band split of [0, h)
    cuts = sorted(set([0, h] + list(
        rng.integers(1, h, size=int(rng.integers(1, 6))))))
    bands = list(zip(cuts[:-1], cuts[1:]))

    # v2: byte parity
    slabs = []
    for ci in range(c):
        for y0, y1 in bands:
            sel = (slice(0, 1), slice(ci, ci + 1), slice(0, 1),
                   slice(y0, y1), slice(0, w))
            slabs.append((sel, full[ci, y0:y1][None, None, None]))
    _assert_file_parity(*_write_both(tmp_path, shape, chunks, dtype, slabs))

    # v3: readback equality
    raw_dir = str(tmp_path / 'fz3')
    mult = int(rng.integers(1, 5))
    create_zarr3_sharded_array(raw_dir, shape, chunks, dtype,
                               shard_multiple=mult, cname=None)
    cl, sh = compute_shard_shape(shape, chunks, mult, 1)
    raw3 = RawV3ShardWriter(raw_dir, shape, cl, sh, dtype)
    assert raw3.ok
    for sel, data in slabs:
        assert raw3.try_write(sel, data)
    a = ts.open({"driver": "zarr3",
                 "kvstore": {"driver": "file", "path": raw_dir}}).result()
    assert (a.read().result()[0, :, 0] == full).all()


def test_leading_chunk_extent_gt1_rejected(tmp_path):
    """Chunk keys and byte sizes assume one (t,c,z) plane per chunk
    file; a z-chunk of 2 once slipped through `ok` and produced stores
    tensorstore could not read back ("Not enough data"). Both writers
    must refuse such layouts up front so callers stay on tensorstore."""
    from image_stitcher_tpu.io.raw_zarr import RawV3ShardWriter
    shape = (1, 1, 4, 64, 64)
    chunks = (1, 1, 2, 32, 32)
    v2 = RawV2SlabWriter(str(tmp_path / 'v2'), shape, chunks, np.uint16)
    assert not v2.ok
    data = np.zeros((1, 1, 2, 32, 64), np.uint16)
    assert not v2.try_write((slice(0, 1), slice(0, 1), slice(0, 2),
                             slice(0, 32), slice(0, 64)), data)
    # v3: shard == chunks on leading axes still must be rejected when
    # the shared extent is > 1 (chunk_nbytes ignores the z extent)
    v3 = RawV3ShardWriter(str(tmp_path / 'v3'), shape, chunks,
                          (1, 1, 2, 64, 64), np.uint16)
    assert not v3.ok


def test_v2_mixing_gate_disables_raw_after_fallback(tmp_path):
    """Raw zarr v2 levels are written by the raw writer alone (no
    tensorstore array to fall back to, so no mixed-writer hazard): a
    slab outside its contract raises before writing anything, the raw
    writer stays enabled, and the store reads back exactly what the
    supported writes put there."""
    import tensorstore as ts

    from image_stitcher_tpu.io.omezarr import MultiscaleWriter
    store = str(tmp_path / 'mix.zarr')
    shape = (1, 1, 1, 64, 128)
    w = MultiscaleWriter(store, shape, 1, np.uint16, (1, 1, 1, 32, 64),
                         name='mix', dz_um=1.0, pixel_size_um=1.0,
                         channel_names=['c0'], channel_colors=[0xFFFFFF],
                         cname=None)
    assert w._raw is not None and w._raw[0].ok and w.arrays is None
    full = np.arange(64 * 128, dtype=np.uint16).reshape(1, 1, 1, 64, 128)
    # unsupported pattern: x does not start at 0
    sel_right = (slice(0, 1), slice(0, 1), slice(0, 1),
                 slice(0, 64), slice(64, 128))
    with pytest.raises(ValueError, match="raw zarr v2 writer"):
        w.write_level(0, full[..., 64:], sel_right, block=True)
    assert w._raw[0].ok
    assert _all_chunk_files(store + '/0') == {}
    # full-width slabs land raw
    for y0 in (0, 32):
        sel = (slice(0, 1), slice(0, 1), slice(0, 1),
               slice(y0, y0 + 32), slice(0, 128))
        assert w.write_level(0, full[..., y0:y0 + 32, :], sel, block=True)
    w.close()
    a = ts.open({"driver": "zarr",
                 "kvstore": {"driver": "file", "path": store + '/0'}}
                ).result()
    assert (a.read().result() == full).all()


# ------------------------------------------------------------ O_DIRECT

def _direct_supported(tmp_path):
    import os
    try:
        fd = os.open(str(tmp_path / ".dprobe"),
                     os.O_WRONLY | os.O_CREAT | os.O_DIRECT, 0o644)
        os.close(fd)
        os.unlink(str(tmp_path / ".dprobe"))
        return True
    except OSError:
        return False


def test_direct_io_byte_parity_v2(tmp_path, rng):
    """O_DIRECT-written chunk files must be byte-identical to the
    buffered pwritev path (same bodies, padding, sparse semantics)."""
    if not _direct_supported(tmp_path):
        pytest.skip("O_DIRECT unsupported on this filesystem")
    shape, chunks = (1, 1, 1, 700, 4096), (1, 1, 1, 256, 2048)
    data1 = rng.integers(0, 65535, (1, 1, 1, 256, 4096), dtype=np.uint16)
    data2 = rng.integers(0, 65535, (1, 1, 1, 188, 4096), dtype=np.uint16)
    sels = [
        (slice(0, 1), slice(0, 1), slice(0, 1), slice(0, 256),
         slice(0, 4096)),
        (slice(0, 1), slice(0, 1), slice(0, 1), slice(512, 700),
         slice(0, 4096)),
    ]
    dirs = {}
    for mode in ("off", "on"):
        d = str(tmp_path / f"v2_{mode}")
        create_zarr_array(d, shape, chunks, np.uint16, cname=None)
        w = RawV2SlabWriter(d, shape, chunks, np.uint16, direct_io=mode)
        assert w.ok
        if mode == "on":
            assert w.direct  # pitch 4096 aligns; fs supports O_DIRECT
        for sel, data in zip(sels, (data1, data2)):
            assert w.try_write(sel, data)
        if mode == "on" and not w.direct:
            pytest.skip("O_DIRECT fell back mid-run")
        dirs[mode] = d
    _assert_file_parity(dirs["off"], dirs["on"])


def test_direct_io_byte_parity_v3(tmp_path, rng):
    if not _direct_supported(tmp_path):
        pytest.skip("O_DIRECT unsupported on this filesystem")
    from image_stitcher_tpu.io.raw_zarr import RawV3ShardWriter
    from image_stitcher_tpu.io.zarr_store import (
        compute_shard_shape, create_zarr3_sharded_array)
    shape, chunks = (1, 1, 1, 512, 4096), (1, 1, 1, 256, 2048)
    cl, sh = compute_shard_shape(shape, chunks, 2)
    data = rng.integers(0, 65535, (1, 1, 1, 512, 4096), dtype=np.uint16)
    sel = tuple(slice(0, s) for s in shape)
    dirs = {}
    for mode in ("off", "on"):
        d = str(tmp_path / f"v3_{mode}")
        create_zarr3_sharded_array(d, shape, chunks, np.uint16,
                                   shard_multiple=2, cname=None)
        w = RawV3ShardWriter(d, shape, cl, sh, np.uint16, direct_io=mode)
        assert w.ok
        assert w.try_write(sel, data)
        dirs[mode] = d
    _assert_file_parity(dirs["off"], dirs["on"])


def test_direct_io_misaligned_pitch_stays_buffered(tmp_path):
    """Chunk widths whose row pitch isn't block-aligned must never take
    the O_DIRECT path, even when forced on."""
    shape, chunks = (1, 1, 1, 256, 1000), (1, 1, 1, 128, 1000)
    d = str(tmp_path / "mis")
    create_zarr_array(d, shape, chunks, np.uint16, cname=None)
    w = RawV2SlabWriter(d, shape, chunks, np.uint16, direct_io="on")
    assert w.ok and not w.direct  # pitch 2000 % 4096 != 0


def test_direct_io_probe_cached(tmp_path, monkeypatch):
    """The buffered-vs-direct probe runs once and lands in the disk
    cache; unsupported filesystems record that and resolve to off."""
    from image_stitcher_tpu.io import directio
    monkeypatch.setattr(directio, "_cache_path",
                        lambda: str(tmp_path / "cache.json"))
    monkeypatch.setattr(directio, "_PROBE_MB", 32)
    directio._mem_cache.clear()
    e1 = directio.probe_direct_io(str(tmp_path), force=True)
    assert e1 is not None and "direct_mbps" in e1
    # second call: served from cache (no new probe files, same entry)
    e2 = directio.probe_direct_io(str(tmp_path))
    assert e2 == e1
    directio._mem_cache.clear()  # leave no cross-test state


def test_direct_io_zero_copy_gather_parity(tmp_path, rng):
    """The zero-copy O_DIRECT gather (page-aligned width-padded source,
    as the streaming fuser's band pool arranges) must produce chunk
    files byte-identical to the buffered path; the misaligned edge
    column rides the staging pack in the same run."""
    if not _direct_supported(tmp_path):
        pytest.skip("O_DIRECT unsupported on this filesystem")
    import mmap

    # width 3000 -> one full 2048 chunk column (aligned, zero-copy) +
    # one 952-px edge column (staging); pad to 4096 like the band pool
    shape, chunks = (1, 1, 1, 700, 3000), (1, 1, 1, 256, 2048)
    alloc_w = 4096
    rows = 700
    mm = mmap.mmap(-1, rows * alloc_w * 2)
    padded = np.frombuffer(mm, np.uint16).reshape(rows, alloc_w)
    padded[:] = 0
    padded[:, :3000] = rng.integers(0, 65535, (rows, 3000), dtype=np.uint16)
    view = padded[:, :3000]
    assert view.ctypes.data % 4096 == 0 and view.strides[0] % 4096 == 0

    dirs = {}
    for mode in ("off", "on"):
        d = str(tmp_path / f"zc_{mode}")
        create_zarr_array(d, shape, chunks, np.uint16, cname=None)
        w = RawV2SlabWriter(d, shape, chunks, np.uint16, direct_io=mode)
        assert w.ok
        # two slabs: chunk-row aligned + a partial straddle
        for y0, y1 in ((0, 256), (256, 700)):
            sel = (slice(0, 1), slice(0, 1), slice(0, 1), slice(y0, y1),
                   slice(0, 3000))
            assert w.try_write(sel, view[y0:y1][None, None, None])
        if mode == "on" and not w.direct:
            pytest.skip("O_DIRECT fell back mid-run")
        dirs[mode] = d
    _assert_file_parity(dirs["off"], dirs["on"])

    # and the store reads back exactly the source
    arr = open_zarr_array(dirs["on"]).read().result()
    np.testing.assert_array_equal(np.asarray(arr)[0, 0, 0], view)


def test_chunk_block_writes_match_tensorstore(tmp_path, rng):
    """try_write_block (chunk-contiguous, one pwrite per chunk file)
    must produce stores identical to a plain tensorstore write: full
    chunks, a multi-chunk-row band (j loop), a partial bottom band, and
    an edge column carrying its own zero padding."""
    import mmap

    shape, chunks = (1, 1, 1, 300, 3000), (1, 1, 1, 128, 2048)
    cy, cx = 128, 2048
    ncx = 2
    full = rng.integers(0, 65535, (300, 3000), dtype=np.uint16)

    d_raw = str(tmp_path / "blocks")
    create_zarr_array(d_raw, shape, chunks, np.uint16, cname=None)
    # force O_DIRECT so the zero-copy pwrite branch is the one tested
    # (skip where the fs refuses, like the other direct-io tests)
    mode = "on" if _direct_supported(tmp_path) else "off"
    w = RawV2SlabWriter(d_raw, shape, chunks, np.uint16, direct_io=mode)
    assert w.ok
    if mode == "on":
        assert w.direct
    assert w.block_spec() == (cy, cx)

    # page-aligned pool like the fuser's: (ncx, band, cx)
    band = 256  # two chunk rows per band
    mm = mmap.mmap(-1, ncx * band * cx * 2)
    pool = np.frombuffer(mm, np.uint16).reshape(ncx, band, cx)
    for band0 in (0, 256):
        rows = min(band, 300 - band0)
        blocks = pool[:, :rows]
        blocks.fill(0)
        for cxi in range(ncx):
            x0, x1 = cxi * cx, min((cxi + 1) * cx, 3000)
            blocks[cxi][:, :x1 - x0] = full[band0:band0 + rows, x0:x1]
            assert w.try_write_block(0, 0, 0, band0, cxi, blocks[cxi])

    d_ts = str(tmp_path / "ts")
    create_zarr_array(d_ts, shape, chunks, np.uint16, cname=None)
    open_zarr_array(d_ts, writable=True)[0, 0, 0].write(full).result()
    _assert_file_parity(d_ts, d_raw)


def test_chunk_block_rejects_bad_shapes(tmp_path, rng):
    shape, chunks = (1, 1, 1, 256, 2048), (1, 1, 1, 128, 2048)
    d = str(tmp_path / "b")
    create_zarr_array(d, shape, chunks, np.uint16, cname=None)
    w = RawV2SlabWriter(d, shape, chunks, np.uint16, direct_io="off")
    good = np.zeros((128, 2048), np.uint16)
    assert w.try_write_block(0, 0, 0, 0, 0, good)
    assert not w.try_write_block(0, 0, 0, 0, 0, good[:, :100])   # wrong cx
    assert not w.try_write_block(0, 0, 0, 64, 0, good)           # y0 misaligned
    assert not w.try_write_block(0, 0, 0, 0, 1, good)            # cxi out of grid
    assert not w.try_write_block(0, 0, 0, 192, 0, good)          # past bottom
    assert not w.try_write_block(0, 0, 0, 0, 0,
                                 good.astype(np.uint8))          # dtype


def test_v3_chunk_block_writes_match_tensorstore(tmp_path, rng):
    """v3 twin of the block-write parity test: chunk-contiguous blocks
    into shard bodies, multi-chunk-row band, partial bottom, edge
    column with in-buffer zero padding."""
    import mmap

    from image_stitcher_tpu.io.raw_zarr import RawV3ShardWriter
    from image_stitcher_tpu.io.zarr_store import (
        compute_shard_shape, create_zarr3_sharded_array)

    shape, chunks = (1, 1, 1, 300, 3000), (1, 1, 1, 128, 2048)
    cy, cx = 128, 2048
    ncx = 2
    full = rng.integers(0, 65535, (300, 3000), dtype=np.uint16)
    cl, sh = compute_shard_shape(shape, chunks, 2)

    d_raw = str(tmp_path / "v3blocks")
    create_zarr3_sharded_array(d_raw, shape, chunks, np.uint16,
                               shard_multiple=2, cname=None)
    mode = "on" if _direct_supported(tmp_path) else "off"
    w = RawV3ShardWriter(d_raw, shape, cl, sh, np.uint16, direct_io=mode)
    assert w.ok
    assert w.block_spec() == (cy, cx)

    band = 256
    mm = mmap.mmap(-1, ncx * band * cx * 2)
    pool = np.frombuffer(mm, np.uint16).reshape(ncx, band, cx)
    for band0 in (0, 256):
        rows = min(band, 300 - band0)
        blocks = pool[:, :rows]
        blocks.fill(0)
        for cxi in range(ncx):
            x0, x1 = cxi * cx, min((cxi + 1) * cx, 3000)
            blocks[cxi][:, :x1 - x0] = full[band0:band0 + rows, x0:x1]
            assert w.try_write_block(0, 0, 0, band0, cxi, blocks[cxi])

    arr = np.asarray(open_zarr_array(d_raw).read().result())
    np.testing.assert_array_equal(arr[0, 0, 0], full)

    # byte parity with a full tensorstore write of the same array
    d_ts = str(tmp_path / "v3ts")
    create_zarr3_sharded_array(d_ts, shape, chunks, np.uint16,
                               shard_multiple=2, cname=None)
    open_zarr_array(d_ts, writable=True)[0, 0, 0].write(full).result()
    _assert_file_parity(d_ts, d_raw)
