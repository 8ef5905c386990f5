#!/usr/bin/env python3
"""Stitching CLI — flag surface parity with reference stitcher_cli.py:9-64.

Usage:
    python -m image_stitcher_tpu.cli -i /path/to/acquisition [-r] [-ff] ...
"""

from __future__ import annotations

import argparse
import sys

from .params import EngineOptions, StitchingParameters


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description="Microscopy Image Stitching CLI")
    parser.add_argument('--input-folder', '-i', required=True,
                        help="Input folder containing images to stitch")
    parser.add_argument('--output-format', '-f',
                        choices=['.ome.zarr', '.ome.tiff'], default='.ome.zarr',
                        help="Output format for stitched data (default: .ome.zarr)")
    parser.add_argument('--apply-flatfield', '-ff', action='store_true',
                        help="Apply flatfield correction")
    parser.add_argument('--use-registration', '-r', action='store_true',
                        help="Enable image registration")
    parser.add_argument('--registration-channel', '-rc',
                        help="Channel to use for registration (default: first available channel)")
    parser.add_argument('--registration-z-level', '-rz', type=int, default=0,
                        help="Z-level to use for registration (default: 0)")
    parser.add_argument('--dynamic-registration', action='store_true',
                        help="Use dynamic registration for improved accuracy")
    parser.add_argument('--scan-pattern', '-s',
                        choices=['Unidirectional', 'S-Pattern'],
                        default='Unidirectional',
                        help="Microscope scanning pattern (default: Unidirectional)")
    parser.add_argument('--merge-timepoints', '-mt', action='store_true',
                        help="Merge all timepoints into a single dataset")
    parser.add_argument('--merge-hcs-regions', '-mw', action='store_true',
                        help="Merge all high-content screening regions (wells)")
    parser.add_argument('--params-json',
                        help="Path to a JSON file containing stitching parameters (overrides other arguments)")
    # engine extensions (reference hard-coded these)
    parser.add_argument('--blend-method', choices=['overwrite', 'feather'],
                        default='overwrite',
                        help="Fusion semantics: reference-parity overwrite or feathered blending")
    parser.add_argument('--chunk-size', type=int, default=2048,
                        help="Output zarr chunk edge in px (default: 2048)")
    parser.add_argument('--fusion-batch', type=int, default=8,
                        help="Tiles fused per device batch (default: 8)")
    parser.add_argument('--fusion-device', choices=['auto', 'device', 'host'],
                        default='auto',
                        help="Where fusion runs (default: auto via link probe)")
    parser.add_argument('--registration-scope',
                        choices=['center', 'all-pairs', 'global'],
                        default=None,
                        help="Shift measurement scope: reference-parity "
                             "center pair, robust all-pairs median, or the "
                             "global per-tile position solve")
    parser.add_argument('--flatfield-device', choices=['host', 'device'],
                        default='host',
                        help="Where the flatfield ADMM solve runs")
    parser.add_argument('--zarr-format', type=int, choices=[2, 3], default=2,
                        help="2 = zarr v2 + OME-NGFF 0.4 (reference-"
                             "compatible); 3 = zarr v3 sharded + NGFF 0.5 "
                             "(~10x fewer files at scale)")
    parser.add_argument('--streaming', choices=['auto', 'on', 'off'],
                        default='auto',
                        help="Bounded-memory band-streaming fusion "
                             "(default: auto above the canvas threshold)")
    parser.add_argument('--tiff-compression',
                        choices=['deflate', 'raw', 'jpeg'], default='deflate',
                        help=".ome.tiff tile codec: deflate (lossless, "
                             "default), raw, or jpeg (lossy, uint8 only — "
                             "the reference's pyvips production default)")
    parser.add_argument('--tiff-jpeg-quality', type=int, default=85,
                        help="JPEG quality 1-100 for --tiff-compression "
                             "jpeg (default 85)")
    parser.add_argument('--resume', action='store_true',
                        help="Continue the most recent interrupted run for this acquisition")
    parser.add_argument('--continue-on-error', action='store_true',
                        help="Log-and-continue on per-region failures")
    parser.add_argument('--registration-report', action='store_true',
                        help="Write registration_report.json (per-pair "
                             "shifts + confidences, solve residuals)")
    return parser.parse_args(argv)


def create_params(args: argparse.Namespace) -> StitchingParameters:
    """Build parameters (parity with reference stitcher_cli.py:66-85)."""
    if args.params_json:
        return StitchingParameters.from_json(args.params_json)
    return StitchingParameters.from_dict({
        'input_folder': args.input_folder,
        'output_format': args.output_format,
        'apply_flatfield': args.apply_flatfield,
        'use_registration': args.use_registration,
        'registration_channel': args.registration_channel or '',
        'registration_z_level': args.registration_z_level,
        'scan_pattern': args.scan_pattern,
        'merge_timepoints': args.merge_timepoints,
        'merge_hcs_regions': args.merge_hcs_regions,
        'dynamic_registration': args.dynamic_registration,
    })


def create_options(args: argparse.Namespace) -> EngineOptions:
    return EngineOptions(
        blend_method=args.blend_method,
        chunks=(1, 1, 1, args.chunk_size, args.chunk_size),
        fusion_batch=args.fusion_batch,
        fusion_device=getattr(args, 'fusion_device', 'auto'),
        flatfield_device=getattr(args, 'flatfield_device', 'host'),
        streaming=getattr(args, 'streaming', 'auto'),
        zarr_format=getattr(args, 'zarr_format', 2),
        continue_on_error=getattr(args, 'continue_on_error', False),
        # explicit --registration-scope wins; otherwise the reference's
        # dead dynamic_registration flag (SURVEY.md §2c) selects the
        # robust all-pairs scope
        registration_scope=(getattr(args, 'registration_scope', None)
                            or ('all-pairs' if args.dynamic_registration
                                else 'center')),
        registration_report=getattr(args, 'registration_report', False),
        tiff_compression=getattr(args, 'tiff_compression', 'deflate'),
        tiff_jpeg_quality=getattr(args, 'tiff_jpeg_quality', 85),
    )


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        params = create_params(args)
        options = create_options(args)
        from .models.pipeline import StitchPipeline
        from .utils.progress import ProgressReporter

        def show_progress(cur, total):
            print(f"\rProgress: {cur}/{total}", end='', flush=True)

        reporter = ProgressReporter(
            update_progress=show_progress,
            status=lambda msg, is_saving=False: print(f"\n{msg}"),
            finished_saving=lambda path, dtype: print(f"\nSaved: {path}"),
        )
        pipeline = StitchPipeline(params, options, reporter,
                                  resume=getattr(args, 'resume', False))
        print("Starting stitching with parameters:")
        print(f"Input folder: {params.input_folder}")
        print(f"Output format: {params.output_format}")
        print(f"Apply flatfield: {params.apply_flatfield}")
        print(f"Use registration: {params.use_registration}")
        if params.use_registration:
            print(f"Registration channel: {params.registration_channel}")
            print(f"Registration Z-level: {params.registration_z_level}")
        print(f"Scan pattern: {params.scan_pattern}")
        print(f"Merge timepoints: {params.merge_timepoints}")
        print(f"Merge HCS regions: {params.merge_hcs_regions}")
        pipeline.run()
        return 0
    except Exception as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1


if __name__ == '__main__':
    sys.exit(main())
