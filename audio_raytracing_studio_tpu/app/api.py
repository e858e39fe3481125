"""Public processing API — signature-compatible with the reference app.

``apply_raytrace_convolution_3d`` and ``process_audio_main_v41`` keep the
exact argument lists, return conventions and error-string behavior of
/root/reference/raytracer_studio.py:991-1174 (the north star requires the
public functions and entry points preserved), but the compute inside is the
jitted device pipeline and the on-device meter.
"""

from __future__ import annotations

import logging
import os
import shutil
import tempfile
from typing import Optional, Tuple

import numpy as np

from .. import config
from ..analysis.metrics import metrics_string
from ..models import pipeline
from ..params import RenderParams
from ..utils import wavio

log = logging.getLogger("ars_tpu.app")


def _file_path(obj) -> Optional[str]:
    """Gradio file objects carry .name; plain strings pass through."""
    return getattr(obj, "name", obj)


def apply_raytrace_convolution_3d(
    audio_file_path,
    external_ir_path,
    use_external_ir_cb,
    hall_type_val,
    room_size_val,
    diffusion_val,
    air_absorption_val,
    base_early_level,
    base_late_level,
    dry_wet,
    dry_wet_kill_start,
    bass_gain,
    treble_gain,
    x_pos,
    y_pos,
    z_pos,
    material,
    target_channel_layout,
    seed: Optional[int] = None,
) -> Tuple[Optional[str], Optional[str], str]:
    """Full render: load → (hall | external IR) → pan → map → PCM_16 WAV.

    Returns (player_path, download_path, metrics_string); on any failure
    (None, None, error_message) — the reference's error contract
    (raytracer_studio.py:991-1109).  ``seed`` is a rebuild extension fixing
    the reference's unseeded RNG; None keeps fresh randomness per call.
    """
    temp_output_file_path = None
    try:
        # --- parameter validation / coercion (ref :1000-1007) ---
        try:
            if not (
                isinstance(hall_type_val, str)
                and isinstance(material, str)
                and isinstance(target_channel_layout, str)
            ):
                raise ValueError("Ungültiger String-Inputtyp.")
            p = RenderParams(
                use_external_ir=bool(use_external_ir_cb),
                hall_type=hall_type_val,
                material=material,
                room_size=float(room_size_val),
                diffusion=float(diffusion_val),
                air_absorption=float(air_absorption_val),
                early_level=float(base_early_level),
                late_level=float(base_late_level),
                dry_wet=float(dry_wet),
                dry_wet_kill_start=float(dry_wet_kill_start),
                bass_gain=float(bass_gain),
                treble_gain=float(treble_gain),
                x_pos=float(x_pos),
                y_pos=float(y_pos),
                z_pos=float(z_pos),
                target_layout=target_channel_layout,
            )
        except (ValueError, TypeError, AttributeError) as e:
            return None, None, f"Fehlerhafte Eingabeparameter: {e}"

        # --- audio input (ref :1010-1017) ---
        file_path = _file_path(audio_file_path)
        try:
            samples_float, rate = wavio.read(file_path)
            if samples_float.size == 0:
                raise ValueError("Audiodatei ist leer.")
        except Exception as load_err:
            return None, None, f"Fehler beim Laden: {load_err}"

        # --- render (external IR | internal hall) ---
        external_ir = None
        external_ir_rate = None
        if p.use_external_ir:
            ir_path = _file_path(external_ir_path)
            if not ir_path or not os.path.exists(ir_path):
                return None, None, "Externe IR gewählt, aber keine Datei gefunden."
            try:
                external_ir, external_ir_rate = wavio.read(ir_path)
                if external_ir.size == 0:
                    raise ValueError("Externe IR-Datei ist leer.")
            except Exception as ir_err:
                return None, None, f"Fehler Laden/Resample IR: {ir_err}"

        try:
            # initialize the backend and compile cache before the first
            # render (utils/runtime.ensure_backend)
            from ..utils.runtime import ensure_backend

            ensure_backend()
            seed_val = (
                seed
                if seed is not None
                else int.from_bytes(os.urandom(4), "little")
            )
            final_output, metrics = pipeline.render(
                samples_float,
                rate,
                p,
                seed=seed_val,
                external_ir=external_ir,
                external_ir_rate=external_ir_rate,
                return_metrics=True,
            )
        except ValueError as render_err:
            # stereo-IR rejection etc. keep the reference's message shape
            msg = str(render_err)
            if "stereo" in msg.lower():
                return None, None, "Externe IR muss Stereo sein."
            return None, None, msg
        if final_output is None or final_output.size == 0:
            return None, None, "Fehler während Faltung (Ergebnis leer)."

        output_metrics_text = metrics_string(metrics)

        # --- write PCM_16 WAV (ref :1078-1087) ---
        try:
            with tempfile.NamedTemporaryFile(
                delete=False, suffix=".wav", prefix="processed_"
            ) as tmp:
                temp_output_file_path = tmp.name
            clipped = np.clip(final_output, -config.OUTPUT_CLIP, config.OUTPUT_CLIP)
            if not np.all(np.isfinite(clipped)):
                clipped = np.nan_to_num(clipped, nan=0.0, posinf=0.0, neginf=0.0)
            wavio.write(temp_output_file_path, clipped, rate, subtype="PCM_16")
            return temp_output_file_path, temp_output_file_path, output_metrics_text
        except Exception as write_err:
            if temp_output_file_path and os.path.exists(temp_output_file_path):
                try:
                    os.remove(temp_output_file_path)
                except OSError:
                    pass
            return None, None, f"Fehler beim Schreiben der WAV-Datei: {write_err}"

    except Exception as e:  # noqa: BLE001 — top-level error contract
        log.exception("apply_raytrace_convolution_3d failed")
        if temp_output_file_path and os.path.exists(temp_output_file_path):
            try:
                os.remove(temp_output_file_path)
            except OSError:
                pass
        return None, None, f"Unerwarteter Fehler in apply_raytrace_convolution_3d: {e}"


def process_audio_main_v41(
    audio_upload_path, mic_record_path, external_ir_file, *args, seed=None
):
    """Source selection + render + player-copy, the main button handler.

    Mirrors raytracer_studio.py:1129-1174: upload wins over mic (size
    thresholds 100 / 1024 bytes), exactly 16 control args in preset order,
    result copied to a fresh temp file for the player.
    """
    upload_path = _file_path(audio_upload_path)
    mic_path = _file_path(mic_record_path)

    valid_upload = (
        upload_path and os.path.exists(upload_path) and os.path.getsize(upload_path) > 100
    )
    valid_mic = (
        mic_path and os.path.exists(mic_path) and os.path.getsize(mic_path) > 1024
    )
    if valid_upload:
        source = upload_path
    elif valid_mic:
        source = mic_path
    else:
        return None, None, "Keine gültige Quelle"

    if len(args) != len(config.PRESET_KEYS):
        return (
            None,
            None,
            f"Interner Fehler: Argumentanzahl ({len(args)} statt {len(config.PRESET_KEYS)}).",
        )

    player_tmp, download_tmp, metrics_str = apply_raytrace_convolution_3d(
        audio_file_path=source,
        external_ir_path=external_ir_file,
        use_external_ir_cb=args[0],
        hall_type_val=args[1],
        room_size_val=args[3],
        diffusion_val=args[4],
        air_absorption_val=args[5],
        base_early_level=args[6],
        base_late_level=args[7],
        dry_wet=args[8],
        dry_wet_kill_start=args[9],
        bass_gain=args[10],
        treble_gain=args[11],
        x_pos=args[12],
        y_pos=args[13],
        z_pos=args[14],
        material=args[2],
        target_channel_layout=args[15],
        seed=seed,
    )

    if player_tmp and os.path.exists(player_tmp):
        try:
            with tempfile.NamedTemporaryFile(
                delete=False, suffix=".wav", prefix="gradio_out_"
            ) as tmp:
                serve_path = tmp.name
            shutil.copy2(player_tmp, serve_path)
            try:
                os.remove(player_tmp)
            except OSError:
                pass
            return serve_path, serve_path, metrics_str
        except Exception as copy_err:
            log.warning("player copy failed: %s", copy_err)
            if isinstance(metrics_str, str):
                metrics_str += " (Warnung: Player-Fehler möglich!)"
            return player_tmp, download_tmp, metrics_str
    return None, None, metrics_str
