"""The Gradio UI: ``create_demo_template`` with the reference's surface.

Counterpart of ``editanything_tpu/apps/ui.py`` (the reference's
editany_demo.py:9-466): three input tabs (Click with the point-prompt
radio and the clear-points and reset-image buttons, Brush, All region),
each with its own run button; the control-scale, samples and seed
sliders; the auto-prompt checkbox and the prompts; tile refinement; the
cross-image-drag accordion; the advanced options; the refined, initial
and reference galleries and the prompt text. Every run button passes the
reference's positional parameters (editany_lora.py:609-644 order), so
``process`` takes the same calls as reference pickles and the CLI's
``replay``, mapped by ``apps/cli.py::reference_call_to_kwargs``.

gradio is imported when the module is, and where it is missing
``require_gradio`` raises: the rest of the port stays importable without
it. ``create_combined_app`` is the reference's app.py:15-76, one tab per
editor of ``apps/demos.py::build_combined_editors``.
"""

from __future__ import annotations

from typing import Callable, Optional

try:
    import gradio as gr
    HAS_GRADIO = True
except ImportError:      # headless
    gr = None
    HAS_GRADIO = False


def require_gradio():
    if not HAS_GRADIO:
        raise ImportError(
            "gradio is not installed; use the CLI "
            "(python -m editanything_tpu_torch.apps.cli) or install gradio")


DEFAULT_N_PROMPT = ("longbody, lowres, bad anatomy, bad hands, missing "
                    "fingers, extra digit, fewer digits, cropped, worst "
                    "quality, low quality, NSFW")


def create_demo_template(process: Callable,
                         process_image_click: Optional[Callable] = None,
                         *, examples=None, INFO: str = "EditAnything",
                         WARNING_INFO: Optional[str] = None,
                         enable_auto_prompt_default: bool = False):
    """Builds the edit UI (editany_demo.py:9 contract). `process` takes the
    reference's positionals (apps/cli.py::REF_PROCESS_PARAMS order);
    `process_image_click` takes (origin_image, point_label, clicked_points,
    image_resolution) and returns (overlay, clicked_points, click_mask)."""
    require_gradio()

    block = gr.Blocks()
    with block:
        clicked_points = gr.State([])
        origin_image = gr.State(None)
        click_mask = gr.State(None)
        gr.Markdown(f"## {INFO}")
        with gr.Row():
            with gr.Column():
                with gr.Tab("Click🖱"):
                    source_image_click = gr.Image(
                        type="numpy", interactive=True,
                        label="Image: click the region you want to edit")
                    with gr.Row():
                        point_prompt = gr.Radio(
                            choices=["Foreground Point", "Background Point"],
                            value="Foreground Point", label="Point Label")
                        clear_button_click = gr.Button(
                            value="Clear Points")
                        clear_button_image = gr.Button(value="Reset Image")
                    run_button_click = gr.Button(value="Run EditAnything")
                with gr.Tab("Brush🖌️"):
                    source_image_brush = gr.Image(
                        type="numpy", tool="sketch",
                        label="Image: cover the edit region with sketch")
                    run_button = gr.Button(value="Run EditAnything")
                with gr.Tab("All region"):
                    source_image_clean = gr.Image(
                        type="numpy", label="Image: upload an image")
                    run_button_allregion = gr.Button(
                        value="Run EditAnything")
                control_scale = gr.Slider(
                    label="SAM Mask Alignment Strength", minimum=0,
                    maximum=1, value=0.5, step=0.1)
                with gr.Row():
                    num_samples = gr.Slider(
                        label="Images", minimum=1, maximum=12, value=2,
                        step=1)
                    seed = gr.Slider(label="Seed", minimum=-1,
                                     maximum=2147483647, step=1,
                                     randomize=True)
                enable_auto_prompt = gr.Checkbox(
                    label="Prompt Auto Generation (BLIP2)",
                    value=enable_auto_prompt_default)
                with gr.Row():
                    a_prompt = gr.Textbox(
                        label="Positive Prompt",
                        value="best quality, extremely detailed,")
                    n_prompt = gr.Textbox(label="Negative Prompt",
                                          value=DEFAULT_N_PROMPT)
                with gr.Row():
                    enable_tile = gr.Checkbox(
                        label="High-resolution Refinement", value=True)
                    refine_alignment_ratio = gr.Slider(
                        label="Similarity with Initial Results", minimum=0,
                        maximum=1, value=0.95, step=0.05)
                with gr.Accordion("Cross-image Drag Options", open=False):
                    ref_image = gr.Image(
                        type="numpy", tool="sketch",
                        label="Reference image: cover the region to use "
                              "with sketch")
                    with gr.Row():
                        ref_auto_prompt = gr.Checkbox(
                            label="Ref. Auto Prompt", value=True)
                        ref_prompt = gr.Textbox(
                            label="Prompt",
                            value="best quality, extremely detailed, ")
                    with gr.Row():
                        reference_attn = gr.Checkbox(
                            label="reference_attn", value=True)
                        reference_adain = gr.Checkbox(
                            label="reference_adain", value=True)
                    with gr.Row():
                        ref_sam_scale = gr.Slider(
                            label="Pos Control Scale", minimum=0,
                            maximum=1.0, value=0.3, step=0.1)
                        ref_inpaint_scale = gr.Slider(
                            label="Content Control Scale", minimum=0,
                            maximum=1.0, value=0.2, step=0.1)
                    with gr.Row():
                        ref_textinv = gr.Checkbox(
                            label="Use textual inversion token",
                            value=False)
                        ref_textinv_path = gr.Textbox(
                            label="textual inversion token path",
                            value=None)
                    with gr.Accordion("Advanced options", open=False):
                        style_fidelity = gr.Slider(
                            label="Style fidelity", minimum=0, maximum=1.0,
                            value=0.0, step=0.1)
                        attention_auto_machine_weight = gr.Slider(
                            label="Attention Reference Weight", minimum=0,
                            maximum=1.0, value=1.0, step=0.01)
                        gn_auto_machine_weight = gr.Slider(
                            label="GroupNorm Reference Weight", minimum=0,
                            maximum=1.0, value=1.0, step=0.01)
                        ref_scale = gr.Slider(
                            label="Frequency Reference Guidance Scale",
                            minimum=0, maximum=1.0, value=0.0, step=0.1)
                with gr.Accordion("Advanced Options", open=False):
                    mask_image = gr.Image(
                        type="numpy", label="Predefined mask of the edit "
                        "region (use with the Brush tab)")
                    image_resolution = gr.Slider(
                        label="Image Resolution", minimum=256, maximum=768,
                        value=512, step=64)
                    refine_image_resolution = gr.Slider(
                        label="Refine Resolution", minimum=256,
                        maximum=8192, value=1024, step=64)
                    guess_mode = gr.Checkbox(label="Guess Mode",
                                             value=False)
                    detect_resolution = gr.Slider(
                        label="SAM Detect Resolution", minimum=128,
                        maximum=2048, value=1024, step=1)
                    ddim_steps = gr.Slider(
                        label="Steps", minimum=1, maximum=100, value=30,
                        step=1)
                    scale = gr.Slider(
                        label="Guidance Scale", minimum=0.1, maximum=30.0,
                        value=9.0, step=0.1)
                    alpha_weight = gr.Slider(
                        label="Alpha weight", minimum=0, maximum=1,
                        value=0.0, step=0.1)
                    use_scale_map = gr.Checkbox(label="Use scale map",
                                                value=False)
                    eta = gr.Number(label="eta (DDIM)", value=0.0)
                    condition_model = gr.Textbox(
                        label="Condition model path", value="EditAnything")
            with gr.Column():
                result_gallery_refine = gr.Gallery(
                    label="Output High quality")
                result_gallery_init = gr.Gallery(label="Output Low quality")
                result_gallery_ref = gr.Gallery(label="Output Ref")
                result_text = gr.Textbox(label="ALL Prompt Text")

        outputs = [result_gallery_refine, result_gallery_init,
                   result_gallery_ref, result_text]

        def ips(source, all_generate, mask):
            """The positionals in editany_lora.py:609-644 order."""
            return [source, gr.State(all_generate), mask, control_scale,
                    enable_auto_prompt, a_prompt, n_prompt, num_samples,
                    image_resolution, detect_resolution, ddim_steps,
                    guess_mode, scale, seed, eta, enable_tile,
                    refine_alignment_ratio, refine_image_resolution,
                    alpha_weight, use_scale_map, condition_model, ref_image,
                    attention_auto_machine_weight, gn_auto_machine_weight,
                    style_fidelity, reference_attn, reference_adain,
                    ref_prompt, ref_sam_scale, ref_inpaint_scale,
                    ref_auto_prompt, ref_textinv, ref_textinv_path,
                    ref_scale]

        run_button.click(fn=process,
                         inputs=ips(source_image_brush, False, mask_image),
                         outputs=outputs)
        run_button_allregion.click(
            fn=process, inputs=ips(source_image_clean, True, mask_image),
            outputs=outputs)
        run_button_click.click(
            fn=process, inputs=ips(origin_image, False, click_mask),
            outputs=outputs)

        if process_image_click is not None:
            source_image_click.upload(
                lambda image: (image.copy() if image is not None else None),
                inputs=[source_image_click], outputs=[origin_image])
            source_image_click.select(
                fn=process_image_click,
                inputs=[origin_image, point_prompt, clicked_points,
                        image_resolution],
                outputs=[source_image_click, clicked_points, click_mask])
        clear_button_click.click(
            fn=lambda original: ((original.copy(), [], None)
                                 if original is not None
                                 else (None, [], None)),
            inputs=[origin_image],
            outputs=[source_image_click, clicked_points, click_mask])
        clear_button_image.click(
            fn=lambda: (None, [], None, None, None), inputs=[],
            outputs=[source_image_click, clicked_points, click_mask,
                     result_gallery_init, result_text])
        if WARNING_INFO:
            gr.Markdown(WARNING_INFO)
        if examples:
            gr.Examples(examples=examples, inputs=[a_prompt])
    return block


def create_demo(editor, **kw):
    """editany.py:10-26: an EditAnythingEditor wired to the UI. The run
    handlers take the reference's positionals and map them through
    ``apps/cli.py::reference_call_to_kwargs``, the one mapping of the UI,
    the CLI's replay and reference pickles."""
    require_gradio()
    from editanything_tpu_torch.apps.cli import reference_call_to_kwargs

    def process(*ref_args):
        kwargs = reference_call_to_kwargs(ref_args)
        tile, results, seg, used = editor.process(**kwargs)
        return tile, list(results), seg, used

    def process_image_click(origin_image, point_label, clicked_points,
                            image_resolution, evt: "gr.SelectData" = None):
        x, y = evt.index
        # the clicked points in gradio's state are authoritative (the
        # reference threads them through it, editany_demo.py:427-434); the
        # editor is synced to them, so sessions and clears agree
        editor.click_points = list(clicked_points or [])
        overlay, mask = editor.process_image_click(
            origin_image, x, y, point_label == "Foreground Point",
            detect_resolution=int(image_resolution))
        return overlay, list(editor.click_points), mask

    block = create_demo_template(process, process_image_click, **kw)
    return block


def create_combined_app(editors: dict, **kw):
    """The reference's combined app (app.py:15-76): one tab per editor
    (e.g. "Edit Anything" and "Beauty"), sharing the SAM and BLIP-2 their
    editors were built with."""
    require_gradio()
    block = gr.Blocks()
    with block:
        with gr.Tabs():
            for name, editor in editors.items():
                with gr.TabItem(name):
                    create_demo(editor, **kw)
    return block
