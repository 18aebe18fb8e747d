"""Caption sentinels the decoder is trained on (copy of ``tpucap.text.clean``'s
constants)."""

START_TOKEN = "startseq"
END_TOKEN = "endseq"
