"""Device ms a task of the kernels launched inside the port's
``step.optimizer`` span (the global norm, the clip scale and AdamW's
update) over the tasks of the traced train window."""
from benchlib.program_trace import device_ms_a_task


def read(obs):
    return device_ms_a_task(obs, "step.optimizer")
