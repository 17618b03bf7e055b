"""``ZipVoiceDistill``: the guidance scale embedded, no CFG doubling."""

from zipvoice_tpu_torch.models import zipvoice as zv
from zipvoice_tpu_torch.models.distill import distill_config

from zipvoice.models.zipvoice import EulerSolver, ReferenceAPI, model_config


class ZipVoiceDistill(ReferenceAPI, zv.ZipVoiceModel):
    def __init__(self, vocab_size: int = 26, pad_id: int = 0, **raw):
        super().__init__(distill_config(model_config(raw, vocab_size, pad_id)))
        self.pad_id = pad_id
        self.solver = EulerSolver(self, distill=True)
