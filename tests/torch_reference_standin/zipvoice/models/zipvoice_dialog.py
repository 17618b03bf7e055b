"""``ZipVoiceDialog`` and ``ZipVoiceDialogStereo``: the speaker-turn
embeddings added to the text encoder's output; the stereo model's
two-stream fm_decoder samples 2F features."""

from zipvoice_tpu_torch.models import dialog as dlg

from zipvoice.models.zipvoice import EulerSolver, ReferenceAPI, model_config


class ZipVoiceDialog(ReferenceAPI, dlg.ZipVoiceDialogModel):
    stereo = False

    def __init__(self, vocab_size: int = 26, pad_id: int = 0,
                 spk_a_id: int = dlg.SPK_A_ID_DEFAULT, spk_b_id: int = dlg.SPK_B_ID_DEFAULT,
                 **raw):
        super().__init__(model_config(raw, vocab_size, pad_id), stereo=self.stereo)
        self.pad_id = pad_id
        self.spk_a_id, self.spk_b_id = spk_a_id, spk_b_id
        self.solver = EulerSolver(self)

    def text_embed(self, tokens_padded, tokens_lens):
        return dlg.forward_text_embed(self, tokens_padded, tokens_lens,
                                      spk_a_id=self.spk_a_id, spk_b_id=self.spk_b_id)


class ZipVoiceDialogStereo(ZipVoiceDialog):
    stereo = True
