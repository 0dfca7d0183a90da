"""Device ms a task of the kernels launched inside the port's
``step.forward`` span (the masters' cast and the train loss, one span a
microbatch), on whichever thread they were launched, over the tasks of
the traced train window."""
from benchlib.program_trace import device_ms_a_task


def read(obs):
    return device_ms_a_task(obs, "step.forward")
