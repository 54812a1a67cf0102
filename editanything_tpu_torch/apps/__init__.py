"""Front ends: the command line (``apps/cli.py``), the Gradio UI
(``apps/ui.py``, where gradio is installed), the demo presets, the
combined editors and the semantic-label overlay (``apps/demos.py``)."""
