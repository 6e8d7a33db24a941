"""Host-side native runtime: the telemetry sink (``csrc/telemetry.cpp``)."""
