@echo off
rem Install the optional extras for the full studio experience.
rem The core framework needs only jax, numpy, scipy (see pyproject.toml).
rem Windows counterpart of setup_studio.sh (reference ships both .sh and .bat:
rem /root/reference/setup_raytracer_studio.bat).

echo ==========================================
echo  Audio Raytracing Studio - Setup
echo ==========================================
echo.

echo [1/2] Installing optional Python packages (web UI + visualizer)...
pip install gradio matplotlib pillow

echo.
echo [2/2] Done. Launch the studio with:
echo     python -m audio_raytracing_studio_tpu.app.studio
echo.
pause
