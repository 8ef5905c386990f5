"""image_stitcher_tpu — accelerator-native microscopy image stitching.

A ground-up JAX/XLA rebuild of the Squid microscope stitcher
(reference: sohamazing/image-stitcher): acquisition parsing, BaSiC-style
flatfield correction, FFT phase-correlation registration with subpixel
refinement, batched tile fusion into (T,C,Z,Y,X) canvases, and multiscale
OME-Zarr / OME-TIFF output — one jit-compiled engine instead of the
reference's three divergent CPU pipelines.
"""

import os as _os

#: where the persistent XLA compilation cache lives when
#: JAX_COMPILATION_CACHE_DIR is unset: a fixed path inside the checkout
#: (the path is part of the cache key, so it must not move between runs)
DEFAULT_COMPILE_CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".jax_cache")


def compile_cache_dir() -> str:
    """The persistent compile-cache directory: JAX_COMPILATION_CACHE_DIR
    when set, else :data:`DEFAULT_COMPILE_CACHE_DIR`."""
    return (_os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or DEFAULT_COMPILE_CACHE_DIR)


# Stitching runs are short-lived processes (CLI, process editions), so
# without a persistent cache every run pays every compile again. jax
# reads JAX_COMPILATION_CACHE_DIR itself; only the fallback is set here.
import jax as _jax

if _jax.config.jax_compilation_cache_dir is None:
    _jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from .params import EngineOptions, StitchingParameters
from .io.acquisition import Acquisition, scan_acquisition
from .utils.progress import ProgressReporter, StitchCancelled

__version__ = "0.1.0"


def stitch(input_folder: str, **kwargs):
    """One-call convenience API: stitch an acquisition folder.

    Keyword args are StitchingParameters fields (plus ``options`` for an
    EngineOptions instance). Returns the StitchPipeline after the run.
    """
    from .models.pipeline import StitchPipeline
    options = kwargs.pop('options', None)
    reporter = kwargs.pop('reporter', None)
    stop_event = kwargs.pop('stop_event', None)
    resume = kwargs.pop('resume', False)
    params = StitchingParameters(input_folder=input_folder, **kwargs)
    pipeline = StitchPipeline(params, options, reporter, stop_event,
                              resume=resume)
    pipeline.run()
    return pipeline


from .api import StitchedImage, list_outputs, open_stitched

__all__ = [
    'Acquisition', 'EngineOptions', 'ProgressReporter', 'StitchCancelled',
    'StitchedImage', 'StitchingParameters', 'list_outputs', 'open_stitched',
    'scan_acquisition', 'stitch',
]
