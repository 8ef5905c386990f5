"""Stitching parameters: validated config dataclass with JSON round-trip.

Public schema kept compatible with the reference CLI/JSON surface
(see reference stitcher_parameters.py:8-107): same field names, same
defaults, same ``validate()`` rules, same timestamped ``stitched_folder``
derivation, same ``from_dict``/``from_json``/``to_dict``/``to_json``.

Engine knobs live in :class:`EngineOptions` so the user-facing
parameter schema stays drop-in compatible.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, fields
from datetime import datetime
from typing import Any, Dict, Optional, Tuple

VALID_OUTPUT_FORMATS = ('.ome.zarr', '.ome.tiff')
VALID_SCAN_PATTERNS = ('Unidirectional', 'S-Pattern')


def _available_cpus() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # non-Linux
        return os.cpu_count() or 1


@dataclass
class StitchingParameters:
    """Parameters for microscopy image stitching operations.

    Field names and defaults mirror the reference schema
    (stitcher_parameters.py:8-29) so that ``--params-json`` files written
    for the reference work unchanged.
    """

    # Required
    input_folder: str

    # Output configuration
    output_format: str = '.ome.zarr'

    # Image processing options
    apply_flatfield: bool = False

    # Registration options
    use_registration: bool = False
    registration_channel: str = ''  # empty -> first available channel
    registration_z_level: int = 0
    dynamic_registration: bool = False

    # Scanning / stitching configuration
    scan_pattern: str = 'Unidirectional'  # or 'S-Pattern'
    merge_timepoints: bool = False
    merge_hcs_regions: bool = False

    def __post_init__(self) -> None:
        self.input_folder = os.path.abspath(self.input_folder)

    def validate(self) -> None:
        """Validate parameters; raises ValueError on invalid/incompatible ones.

        Mirrors reference stitcher_parameters.py:36-58.
        """
        if not os.path.exists(self.input_folder):
            raise ValueError(f"Input folder does not exist: {self.input_folder}")
        if self.output_format not in VALID_OUTPUT_FORMATS:
            raise ValueError("Output format must be either .ome.zarr or .ome.tiff")
        if self.scan_pattern not in VALID_SCAN_PATTERNS:
            raise ValueError("Scan pattern must be either 'Unidirectional' or 'S-Pattern'")
        if self.use_registration:
            if self.registration_z_level < 0:
                raise ValueError("Registration Z-level must be non-negative")
            # registration_channel may be empty -> first available channel

    @property
    def stitched_folder(self) -> str:
        """Timestamped output folder next to the input folder.

        Format parity with reference stitcher_parameters.py:61-64.
        """
        stamp = datetime.now().strftime('%Y-%m-%d_%H-%M-%S.%f')
        return os.path.join(self.input_folder + "_stitched_" + stamp)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> 'StitchingParameters':
        valid = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in valid})

    @classmethod
    def from_json(cls, json_path: str) -> 'StitchingParameters':
        with open(json_path) as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> Dict[str, Any]:
        return {f.name: getattr(self, f.name) for f in fields(self)}

    def to_json(self, json_path: str) -> None:
        with open(json_path, 'w') as f:
            json.dump(self.to_dict(), f, indent=2)


@dataclass
class EngineOptions:
    """Engine knobs that the reference hard-coded.

    Every value here was an undocumented constant in the reference; we
    surface them with reference-matching defaults so default runs stay
    output-compatible. (Citations per field.)
    """

    # zarr chunk shape for the (T,C,Z,Y,X) output; reference used
    # (1,1,1,2048,2048) in its production edition (stitcher_process.py:161).
    chunks: Tuple[int, int, int, int, int] = (1, 1, 1, 2048, 2048)
    # Overlap-estimate fudge factor (stitcher.py:451-452).
    overlap_fudge: float = 1.05
    # Fraction of the orthogonal axis trimmed off each side of a
    # registration strip (stitcher.py:504,517).
    registration_margin: float = 0.25
    # Subpixel refinement upsampling (stitcher.py:510,523).
    upsample_factor: int = 10
    # Flatfield sampling budget (stitcher.py:389-394).
    flatfield_tiles_per_timepoint: int = 32
    flatfield_max_tiles: int = 48
    # Blosc compressor. Default = blosc-lz4 clevel 5 with shuffle, the
    # zarr default the reference's primary zarr writer used
    # (stitcher.py:818 zarr.storage.default_compressor); the production
    # zarr_stitcher edition's zstd-1 (zarr_stitcher.py:409) is one knob
    # away. lz4 is ~2x faster per core at similar microscopy ratios.
    # 'auto' probes sample tiles at write time and compresses only when
    # BOTH gates pass: median probe ratio <= 0.6 (content genuinely
    # compresses) and measured output-device bandwidth < 300 MB/s x
    # cores (the disk, not the CPU, is the bottleneck: on a fast disk
    # lz4 costs more core time than the bytes it saves; not measured on
    # the GPU host). Blosc chunks are written through tensorstore
    # ('auto' stores raw where it is not installed); None stores raw
    # chunks through io/raw_zarr.py.
    compressor_cname: Optional[str] = 'lz4'
    compressor_clevel: int = 5
    compressor_shuffle: int = 1
    # O_DIRECT for the raw (compressor-null) chunk/shard writers:
    # 'auto' uses a measured buffered-vs-direct probe per device (disk-
    # cached 24 h, io/directio.py) — on hosts whose writing core also
    # pays page-cache copy + writeback, direct sustains the device's
    # real rate and leaves the input tiles cached (not measured on the
    # GPU host). Output bytes are identical either way.
    direct_io: str = 'auto'
    # Zarr storage format: 2 = zarr v2 + OME-NGFF 0.4 (the reference-
    # compatible tree); 3 = zarr v3 sharded + OME-NGFF 0.5 (~10x fewer
    # files at scale; needs tensorstore).
    zarr_format: int = 2
    # Fusion semantics: 'overwrite' = reference parity (stitcher.py:598,
    # direct slice assignment, later tile wins); 'feather' = weighted
    # blending in overlap zones (an upgrade the reference lacks).
    blend_method: str = 'overwrite'
    # Pyramid downsample: 'nearest' matches the reference zarr save path
    # (ome_zarr Scaler.nearest, stitcher.py:797-798); 'mean' matches the
    # reference merge paths (da.coarsen(np.mean), stitcher.py:893).
    pyramid_downsample: str = 'nearest'
    # Registration scope: 'center' = reference parity (one center pair per
    # axis, stitcher.py:456-485); 'all-pairs' = robust full-grid estimate
    # (median over every adjacent pair); 'global' = MIST/ASHLAR-class
    # per-tile position optimization over the pairwise-shift graph.
    registration_scope: str = 'center'
    # Subpixel placement (global scope): keep the solve's fractional
    # positions and shift tile content by the residual (bilinear) at
    # load time. Best combined with blend_method='feather'.
    subpixel_placement: bool = False
    # Where the flatfield ADMM solve runs: 'host' (NumPy twin — the
    # working-resolution solve is ~100 MFLOP) or 'device' (jitted
    # lax.fori_loop on the same sample stack). Which wins on the GPU is
    # not measured yet; both are exercised end to end by chip_smoke.py.
    flatfield_device: str = 'host'
    # Pair batches at or below this size measure on the host f64 twin;
    # larger batches run the jitted device kernel. 0 = always device.
    registration_device_threshold: int = 32
    # All-pairs/global registration streams pair strips through bounded
    # batches of this many pairs: memory is O(batch), not O(grid) — a
    # 20x20 region (760 pairs) of 2048^2 tiles would otherwise hold
    # ~GBs of strips at once. Batches above the device threshold reuse
    # one compiled kernel shape (short final batches are padded).
    registration_batch_pairs: int = 128
    # Where fusion runs: 'device' (accelerator canvas), 'host' (threaded
    # NumPy + native C), or 'auto': 'device' when jax's default backend
    # is a GPU, 'host' on the CPU backend.
    fusion_device: str = 'auto'
    host_fusion_threads: Optional[int] = None  # None = auto from affinity
    # Feather ramp width in px (blend_method='feather').
    feather_px: int = 64
    # .ome.tiff tile codec: 'deflate' (lossless, any dtype — our
    # default), 'raw', or 'jpeg' (lossy Q=tiff_jpeg_quality, uint8 only
    # — the reference's production pyvips default,
    # stitcher_process.py:1502-1549, which inherits libtiff's 8-bit
    # JPEG limit).
    tiff_compression: str = 'deflate'
    tiff_jpeg_quality: int = 85
    # Host reader threads feeding the device; None = auto from the
    # process's actual CPU affinity (oversubscribing a starved cgroup
    # with threads costs more in context churn than it buys).
    reader_threads: Optional[int] = None
    # Max tiles resident on device per fusion batch.
    fusion_batch: int = 8
    # Write registration-strip debug PNGs like the reference
    # (stitcher.py:508,521,619-637).
    debug_visuals: bool = False
    # Write registration_report.json next to the outputs: per-region
    # pairwise shifts + confidences and (global scope) solve residuals —
    # production observability the reference's debug PNGs approximated.
    registration_report: bool = False
    # Device mesh axis sizes (data, canvas-y). None -> single device.
    mesh_shape: Optional[Tuple[int, int]] = None
    # Pre-merge shard barrier timeout (multi-controller runs): a shard
    # that died mid-run must fail the survivors with recovery guidance,
    # not deadlock them in sync_global_devices forever. 0 disables the
    # timeout (falls back to the untimed collective barrier).
    merge_barrier_timeout_s: float = 600.0
    # Bounded-memory streaming fusion (models/streaming.py): fuse and
    # write the canvas in chunk-aligned bands, never materializing it.
    # 'auto' streams when the canvas would exceed streaming_threshold
    # bytes; host+zarr+overwrite path only. Banded single-pass writing
    # also measures ~30% faster than fuse-then-save at multi-GB sizes,
    # so the threshold sits well below RAM limits.
    streaming: str = 'auto'
    streaming_threshold_bytes: int = 256 << 20
    # Device-streaming band height, in units of write_band_rows(). Tiles
    # straddling a band boundary ship to the device once per band, so a
    # band equal to the tile height pays ~2x H2D; a 4x band cuts the
    # straddle overhead to ~25% for a few hundred MB of extra HBM
    # (bands stay chunk-aligned, so writes are unaffected).
    device_band_multiple: int = 4
    # Report overlapping (order-dependent) tile writes per region before
    # fusing (utils/plan_check) — the race-visibility story the
    # reference lacked (SURVEY.md §5).
    validate_plan: bool = False
    # Overlap each region's save with the next region's fusion via a
    # background writer (bounded depth 1 to cap canvas memory).
    pipelined_save: bool = True
    # Overlap the flatfield fit with the registration measurement (they
    # read disjoint data and share no state; either can cost 10s+
    # through a congested device link).
    overlap_prep: bool = True
    # Log-and-continue on per-region failures instead of aborting the run
    # (upgrade over the reference, which only counted per-FOV errors,
    # zarr_stitcher.py:487-489).
    continue_on_error: bool = False
    # Explicit output folder (overrides the timestamped derivation).
    # Required when several processes cooperate on one output tree.
    output_folder: Optional[str] = None
    # Work sharding for multi-process runs: (index, count) — this
    # process stitches only the (timepoint, region) units whose
    # deterministic enumeration index % count == index (the reference's
    # Pool fan-out, lifted to whole units across hosts). Merges are the
    # coordinator's job (parallel/distributed.stitch_distributed).
    work_shard: Optional[Tuple[int, int]] = None

    # EngineOptions fields that change the OUTPUT (not just performance);
    # a resumed run must match these to keep one coherent output tree.
    OUTPUT_AFFECTING = (
        'chunks', 'overlap_fudge', 'registration_margin', 'upsample_factor',
        'flatfield_tiles_per_timepoint', 'flatfield_max_tiles',
        'compressor_cname', 'compressor_clevel', 'compressor_shuffle',
        'blend_method', 'pyramid_downsample', 'registration_scope',
        'feather_px', 'subpixel_placement', 'zarr_format')

    def output_fingerprint(self) -> Dict[str, Any]:
        return {name: list(v) if isinstance((v := getattr(self, name)), tuple)
                else v
                for name in self.OUTPUT_AFFECTING}

    def write_band_rows(self) -> int:
        """Row granularity for band-streamed writes: the read-chunk
        rows. zarr v3 shards are Y-thin (one chunk row tall, see
        create_zarr3_sharded_array), so chunk-row bands cover whole
        shards on either format — no shard read-modify-write."""
        return self.chunks[3]

    def resolved_reader_threads(self) -> int:
        if self.reader_threads is not None:
            return self.reader_threads
        return max(2, _available_cpus())

    def resolved_fusion_threads(self) -> int:
        if self.host_fusion_threads is not None:
            return self.host_fusion_threads
        # Never fewer than 4: band threads spend much of their life in
        # GIL-released waits (tensorstore write backpressure, mmap page
        # faults), so even a single-core host runs ~2x faster with a few
        # threads in flight (measured on the bench host).
        return max(4, _available_cpus())

    def validate(self) -> None:
        if self.blend_method not in ('overwrite', 'feather'):
            raise ValueError("blend_method must be 'overwrite' or 'feather'")
        if self.pyramid_downsample not in ('nearest', 'mean'):
            raise ValueError("pyramid_downsample must be 'nearest' or 'mean'")
        if self.registration_scope not in ('center', 'all-pairs', 'global'):
            raise ValueError(
                "registration_scope must be 'center', 'all-pairs' or 'global'")
        if self.fusion_device not in ('auto', 'device', 'host'):
            raise ValueError("fusion_device must be 'auto', 'device' or 'host'")
        if self.direct_io not in ('auto', 'on', 'off'):
            raise ValueError("direct_io must be 'auto', 'on' or 'off'")
        if self.flatfield_device not in ('host', 'device'):
            raise ValueError("flatfield_device must be 'host' or 'device'")
        if self.zarr_format not in (2, 3):
            raise ValueError("zarr_format must be 2 (NGFF 0.4) or 3 (NGFF 0.5)")
        if self.work_shard is not None:
            idx, count = self.work_shard
            if not (count >= 1 and 0 <= idx < count):
                raise ValueError("work_shard must be (index, count) with "
                                 "0 <= index < count")
            if self.output_folder is None:
                raise ValueError("work_shard requires an explicit "
                                 "output_folder shared by all shards")
        if self.compressor_cname not in (None, 'auto') or self.zarr_format == 3:
            from .io.zarr_store import have_tensorstore
            if not have_tensorstore():
                raise ValueError(
                    "compressed (Blosc) or zarr v3 output needs the "
                    "tensorstore package, which is not installed; use "
                    "compressor_cname=None and zarr_format=2 for raw "
                    "zarr v2 chunks")
        if self.streaming not in ('auto', 'on', 'off'):
            raise ValueError("streaming must be 'auto', 'on' or 'off'")
        if self.subpixel_placement and self.registration_scope != 'global':
            raise ValueError(
                "subpixel_placement requires registration_scope='global'")
        if len(self.chunks) != 5:
            raise ValueError("chunks must be a 5-tuple (T,C,Z,Y,X)")
        if self.device_band_multiple < 1:
            raise ValueError("device_band_multiple must be >= 1")
        if self.tiff_compression not in ('deflate', 'raw', 'jpeg'):
            raise ValueError(
                "tiff_compression must be 'deflate', 'raw' or 'jpeg'")
        if not 1 <= self.tiff_jpeg_quality <= 100:
            raise ValueError("tiff_jpeg_quality must be in [1, 100]")
