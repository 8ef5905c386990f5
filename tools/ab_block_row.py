"""Interleaved block-vs-row streaming-fusion A/B on the bench fixture.

The chunk-column block banding removes the O_DIRECT staging pack
(~canvas-sized memcpy) from the write stage; its effect (~0.3-0.5 s at
g10) is far below the host's weather swing, so only an interleaved
best-of comparison in ONE window is meaningful. Run:
python tools/ab_block_row.py [reps]
"""
import glob
import os
import shutil
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    import bench
    global ACQ
    ACQ = bench.cached_acquisition()
    bench.prewarm(ACQ)
    from image_stitcher_tpu import EngineOptions, StitchingParameters
    from image_stitcher_tpu.models import streaming as st
    from image_stitcher_tpu.models.pipeline import StitchPipeline
    from image_stitcher_tpu.utils.progress import ProgressReporter

    orig_init = st.StreamingFuser.__init__

    def no_blocks(self, *a, **k):
        orig_init(self, *a, **k)
        self._block_cx = 0

    def run(block: bool) -> float:
        st.StreamingFuser.__init__ = orig_init if block else no_blocks
        params = StitchingParameters(input_folder=ACQ,
                                     use_registration=True,
                                     apply_flatfield=True)
        opts = EngineOptions(fusion_device='host', flatfield_device='host')
        pipe = StitchPipeline(params, opts, reporter=ProgressReporter())
        t0 = time.perf_counter()
        try:
            pipe.run()
        finally:
            st.StreamingFuser.__init__ = orig_init
        dt = time.perf_counter() - t0
        for d in glob.glob(ACQ + "_stitched_*"):
            shutil.rmtree(d, ignore_errors=True)
        return dt

    run(True)  # warmup: page-in + native lib + probe caches
    best = {"block": None, "row": None}
    for rep in range(reps):
        for name, mode in (("block", True), ("row", False)):
            dt = run(mode)
            best[name] = dt if best[name] is None else min(best[name], dt)
            print(f"rep{rep} {name:5s}: {dt:.2f}s  (best {best[name]:.2f})",
                  flush=True)
    if best["block"] and best["row"]:
        print(f"RESULT best block={best['block']:.2f}s "
              f"row={best['row']:.2f}s "
              f"({best['row'] / best['block']:.3f}x)")


if __name__ == "__main__":
    main()
