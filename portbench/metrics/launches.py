"""launches.<kind>: kernel launches (``cudaLaunchKernel``, ``cudaLaunchKernelExC``,
``cuLaunchKernel``, ``cuLaunchKernelEx``) per profiled iteration (view), counted
inside the program's root spans (``trainer.iteration`` and ``trainer.log``, or
``render.frame``) on any thread: the harness's own calls and the render
traffic's copies to the host fall outside them.  Nothing where the program
has no spans (portbench/spans.py)."""

from portbench import spans as S


def read(name, rec):
    return S.per_iteration_calls(rec, S.LAUNCH)
