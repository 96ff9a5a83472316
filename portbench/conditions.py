"""What the host and the card were doing around a run's window, so that a
spread between runs can be traced to its cause.

Read just before and just after the window, never inside it:

* the host: how many CPUs the process may use and, after the window, the
  time a fixed loop of pure Python takes (how fast this process's CPU
  ran; the set-up line's import time is the same reading at the start);
* the card, through NVML (``libnvidia-ml``, loaded with ``ctypes``): its
  SM clock and the highest it may run at, the temperature, the power
  drawn and the reasons the clocks are held down (a bit mask).

Every reading that cannot be taken is left out.
"""

import ctypes
import os
import time

__all__ = ["Conditions"]

_NVML_CLOCK_SM = 1
_NVML_TEMPERATURE_GPU = 0


def _python_loop_ms(n=2_000_000):
    t0 = time.perf_counter()
    x = 0
    for i in range(n):
        x += i
    return (time.perf_counter() - t0) * 1e3


class _Nvml:
    def __init__(self):
        self.lib = None
        try:
            lib = ctypes.CDLL("libnvidia-ml.so.1")
            handle = ctypes.c_void_p()
            if (lib.nvmlInit_v2() == 0 and lib.nvmlDeviceGetHandleByIndex_v2(
                    0, ctypes.byref(handle)) == 0):
                self.lib, self.handle = lib, handle
        except (OSError, AttributeError):
            pass

    def read(self):
        if self.lib is None:
            return {}
        out = {}
        u, ull = ctypes.c_uint(), ctypes.c_ulonglong()
        for key, call, args, scale in (
                ("sm_mhz", "nvmlDeviceGetClockInfo", (_NVML_CLOCK_SM,), 1),
                ("sm_max_mhz", "nvmlDeviceGetMaxClockInfo", (_NVML_CLOCK_SM,),
                 1),
                ("temp_c", "nvmlDeviceGetTemperature",
                 (_NVML_TEMPERATURE_GPU,), 1),
                ("power_w", "nvmlDeviceGetPowerUsage", (), 1e-3)):
            if getattr(self.lib, call)(self.handle, *args,
                                       ctypes.byref(u)) == 0:
                out[key] = u.value * scale
        if self.lib.nvmlDeviceGetCurrentClocksThrottleReasons(
                self.handle, ctypes.byref(ull)) == 0:
            out["held"] = hex(ull.value)
        return out


class Conditions:
    """``before()`` and ``after()`` around the window; ``summary()``."""

    def __init__(self, on_card):
        self.nvml = _Nvml() if on_card else None
        self.card = {}

    def before(self):
        self.card["before"] = self.nvml.read() if self.nvml else {}

    def after(self):
        self.card["after"] = self.nvml.read() if self.nvml else {}
        self.loop_ms = _python_loop_ms()

    def summary(self):
        b, a = self.card["before"], self.card["after"]
        out = {"cpus": len(os.sched_getaffinity(0)),
               "python_loop_ms": self.loop_ms}
        for key in ("sm_mhz", "sm_max_mhz", "temp_c", "power_w", "held"):
            if key in b or key in a:
                out[key] = [b.get(key), a.get(key)]
        return out
