"""host_syncs.<kind>: blocking calls (``cudaStreamSynchronize``,
``cudaDeviceSynchronize``, ``cudaEventSynchronize``, a synchronous
``cudaMemcpy``) per profiled iteration (view), counted inside the program's
root spans on any thread (a ``.item()``, ``int()`` or ``torch.nonzero`` of a
device tensor is one); nothing where the program has no spans
(portbench/spans.py)."""

from portbench import spans as S


def read(name, rec):
    return S.per_iteration_calls(rec, S.SYNC)
