"""Optimizers and the int8 gradient exchange of the train step: AdamW
and Adafactor on dicts of tensors (:mod:`.adamw`, :mod:`.adafactor`), and
the error-feedback exchange between data-parallel replicas on kernels 7
and 8 at group 256 (:mod:`.grad_compress`)."""
