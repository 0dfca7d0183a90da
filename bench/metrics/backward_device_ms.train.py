"""Device ms a task of the kernels launched inside the port's
``step.backward`` span (``torch.autograd.grad`` with the layers' and the
loss chunks' recompute, one span a microbatch), on whichever thread they
were launched: a CUDA backward launches from autograd's own thread."""
from benchlib.program_trace import device_ms_a_task


def read(obs):
    return device_ms_a_task(obs, "step.backward")
