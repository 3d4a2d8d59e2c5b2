"""The plain reference that decides ``correct``: DG-Mesh's training
iteration and inference render written in plain PyTorch from the JAX
package's and upstream's formulas.

It imports nothing of the program (``dgmesh_torch``), of JAX or of the JAX
package, and takes nothing the program made: it builds its own state,
DPSR frame, cameras, mesh and tile lists from the raw inputs the benchmark
makes from the seed.  The program's six CUDA kernels appear here as their
plain twins (``composite.py``: kernels 1-2, ``shade.py``: 3-4,
``trunk.py``: 5-6); everything around them is written anew:
``nets.py`` (the five networks), ``render.py`` (cameras, the splat and the
mesh raster with their tile binning), ``surface.py`` (DPSR on the FFT,
marching tetrahedra over the whole grid) and ``step.py`` (the losses, the
backward, both Adams, the anchoring, the render of a view).
"""
