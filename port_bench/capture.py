"""The benchmark's hooks into the port's SAM path: spans around the calls
into each layer, and copies of what the timed path produced for the
requests that the check samples.

Hooks replace attributes of the editor (its encode and generate
functions, its ``get_sam_control``) and of two port modules (the AMG's
``decode_candidates``, the editor module's ``encode_id_map``); ``undo``
puts every original back.
"""

from __future__ import annotations


class Hooks:
    def __init__(self):
        self._undo = []

    def replace(self, obj, attr, make):
        """Set obj.attr to make(original)."""
        orig = getattr(obj, attr)
        self._undo.append((obj, attr, orig, attr in vars(obj)))
        setattr(obj, attr, make(orig))

    def undo(self):
        for obj, attr, orig, own in reversed(self._undo):
            if own:
                setattr(obj, attr, orig)
            else:
                delattr(obj, attr)
        self._undo = []


class SamCapture(Hooks):
    """On an EditAnythingEditor: spans ``sam_encode`` (the image encoder)
    and ``amg_decode`` (the candidates' decode, selection and the ID map),
    and, while ``key`` is set, the request's image embedding, every
    candidate's predicted IoU and the logits of candidates ``rows``."""

    def __init__(self, run, editor, rows):
        super().__init__()
        from editanything_tpu_torch.perception import amg
        from editanything_tpu_torch.pipelines import editor as editor_mod
        self.key, self.store, self.rows = None, {}, rows

        def encode(orig):
            def fn(sam, x):
                with run.span("sam_encode"):
                    out = orig(sam, x)
                if self.key is not None:
                    self.store.setdefault(self.key, {})["embedding"] = \
                        out.detach().clone()
                return out
            return fn

        def candidates(orig):
            def fn(*args, **kwargs):
                logits, iou = orig(*args, **kwargs)
                if self.key is not None:
                    st = self.store.setdefault(self.key, {})
                    st["iou"] = iou.detach().float().clone()
                    st["logits"] = logits[self.rows].detach().clone()
                return logits, iou
            return fn

        def spanned(orig):
            return run.wrap(orig, "amg_decode")

        self.replace(editor, "_amg_encode", encode)
        self.replace(editor, "_amg_generate", spanned)
        self.replace(amg, "decode_candidates", candidates)
        self.replace(editor_mod, "encode_id_map", spanned)


def rel_max(got, want) -> float:
    """max |got - want| over max |want|."""
    want = want.float()
    return float((got.float() - want).abs().max() / want.abs().max()
                 .clamp(min=1e-30))


def rel_rms(got, want) -> float:
    """||got - want|| over ||want||."""
    want = want.float()
    return float((got.float() - want).norm() / want.norm().clamp(min=1e-30))
