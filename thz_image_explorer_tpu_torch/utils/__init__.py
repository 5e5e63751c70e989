"""Host utilities of the shell: settings persistence, the log ring buffer,
the update check and the slider-drag replay."""

from thz_image_explorer_tpu_torch.utils.logbuffer import LogRingBuffer, install_log_buffer  # noqa: F401
from thz_image_explorer_tpu_torch.utils.settings import PsfToolState, Settings  # noqa: F401
