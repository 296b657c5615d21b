"""Pepper-robot deployment adapter (the port's own copy of the JAX
package's ``apps/pepper.py``).

Behavioral equivalent of the reference's hri-demo bridge
(reference: hri-demo/HRI_demo.py): watch for freshly written wavs, convert
to 16-bit (Pepper's audio player requirement), push them to the robot over
SCP with retry, trigger an ``ALAnimationPlayer.runTag`` gesture, play via
``ALAudioPlayer``, delete the remote file.  Two modes: ``storybuilding``
(loop on one output.wav) and ``storytelling`` (``to_play-<i>.wav`` per
script line).

The robot transport (paramiko/scp + qi) is injected behind
``RobotTransport`` so the file-watching / conversion / sequencing logic is
testable without hardware; ``LocalTransport`` plays locally instead.
"""

from __future__ import annotations

import argparse
import os
import time
from pathlib import Path
from typing import Optional, Protocol

import numpy as np


def format_audio_16bit(input_path: str, output_path: Optional[str] = None) -> str:
    """Convert any wav to 16-bit PCM (reference: HRI_demo.py:81-84, via
    pydub there; numpy/scipy here)."""
    from scipy.io import wavfile

    from emojivoice_tpu_torch.data.audio_np import load_wav

    data, sr = load_wav(input_path)
    out = output_path or input_path.replace(".wav", "_16b.wav")
    wavfile.write(out, sr, (np.clip(data, -1, 1) * 32767).astype(np.int16))
    return out


def wait_for_file_update(file_path: str, wait_for_change: bool = True,
                         poll: float = 0.1, timeout: Optional[float] = None):
    """Block until the file exists, (optionally) updates, and finishes
    writing (reference: HRI_demo.py:110-128)."""
    t0 = time.time()

    def check_timeout():
        if timeout is not None and time.time() - t0 > timeout:
            raise TimeoutError(f"timed out waiting for {file_path}")

    while not os.path.exists(file_path):
        check_timeout()
        time.sleep(poll)
    if wait_for_change:
        initial = os.path.getmtime(file_path)
        while os.path.getmtime(file_path) == initial:
            check_timeout()
            time.sleep(poll)
    last_size = -1
    while os.path.getsize(file_path) != last_size:
        last_size = os.path.getsize(file_path)
        time.sleep(poll * 2)


class RobotTransport(Protocol):
    def push_and_play(self, local_wav: str, remote_name: str, animation: str = "top") -> None: ...


class PepperTransport:
    """paramiko/scp + qi transport (needs robot + libs; reference
    HRI_demo.py:38-108,132-137)."""

    def __init__(self, ip: str, username: str = "nao", password: str = "nao",
                 max_retries: int = 20):
        import paramiko  # noqa: PLC0415
        import qi  # noqa: PLC0415

        self.ip = ip
        self.username = username
        self.password = password
        self.max_retries = max_retries
        self._paramiko = paramiko
        self.app = qi.Application([], url=f"tcps://{ip}:9503")
        # token auth like the reference (HRI_demo.py:132-136)
        self.app.start()
        self.audio_player = self.app.session.service("ALAudioPlayer")

    def _ssh(self):
        ssh = self._paramiko.SSHClient()
        ssh.set_missing_host_key_policy(self._paramiko.AutoAddPolicy())
        ssh.connect(self.ip, username=self.username, password=self.password)
        return ssh

    def _scp_with_retry(self, local: str, remote: str):
        from scp import SCPClient  # noqa: PLC0415

        # bounded retry (the reference recurses unboundedly, HRI_demo.py:51-55)
        for attempt in range(self.max_retries):
            try:
                ssh = self._ssh()
                with SCPClient(ssh.get_transport()) as scp:
                    scp.put(local, remote)
                ssh.close()
                return
            except Exception as e:  # noqa: BLE001
                print(f"transfer failed ({e}); retry {attempt + 1}/{self.max_retries}")
                time.sleep(0.25)
        raise RuntimeError(f"could not transfer {local} to Pepper")

    def push_and_play(self, local_wav: str, remote_name: str, animation: str = "top"):
        remote_path = f"/home/nao/{remote_name}_16b.wav"
        self._scp_with_retry(local_wav, remote_path)
        ssh = self._ssh()
        ssh.exec_command(f"qicli call ALAnimationPlayer.runTag '{animation}'")
        ssh.close()
        self.audio_player.playFile(remote_path)
        ssh = self._ssh()
        ssh.exec_command(f"rm -f {remote_path}")
        ssh.close()


class LocalTransport:
    """Hardware-free fallback: play (or archive) locally."""

    def __init__(self, out_dir: str = "pepper_out"):
        from emojivoice_tpu_torch.apps.adapters import default_audio_sink

        self.sink = default_audio_sink(out_dir)
        self.played = []

    def push_and_play(self, local_wav: str, remote_name: str, animation: str = "top"):
        from emojivoice_tpu_torch.data.audio_np import load_wav

        wav, sr = load_wav(local_wav)
        self.sink.play(wav, sr)
        self.played.append((local_wav, remote_name, animation))


def run_storybuilding(transport: RobotTransport, watch_dir: str, iterations: int = 0,
                      timeout: Optional[float] = None):
    """Loop: wait for output.wav updates and relay each (HRI_demo.py:140-144)."""
    path = str(Path(watch_dir) / "output.wav")
    count = 0
    while iterations <= 0 or count < iterations:
        wait_for_file_update(path, wait_for_change=count > 0, timeout=timeout)
        wav16 = format_audio_16bit(path)
        transport.push_and_play(wav16, "output")
        count += 1
    return count


def run_storytelling(transport: RobotTransport, watch_dir: str, script_path: str,
                     timeout: Optional[float] = None):
    """Relay to_play-<i>.wav for each script line (HRI_demo.py:146-162)."""
    num_lines = sum(1 for line in open(script_path) if line.strip())
    for i in range(num_lines):
        origin = str(Path(watch_dir) / f"to_play-{i}.wav")
        wait_for_file_update(origin, wait_for_change=False, timeout=timeout)
        wav16 = format_audio_16bit(origin)
        transport.push_and_play(wav16, f"to_play-{i}")
        for f in (origin, wav16):
            try:
                os.remove(f)
            except OSError:
                pass
    return num_lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="emojivoice-pepper-torch")
    p.add_argument("demo", choices=["storybuilding", "storytelling"])
    p.add_argument("--ip", default=None, help="Pepper IP (omit for local playback)")
    p.add_argument("--watch_dir", default=".")
    p.add_argument("--script", default=None)
    args = p.parse_args(argv)

    transport = PepperTransport(args.ip) if args.ip else LocalTransport()
    if args.demo == "storybuilding":
        run_storybuilding(transport, args.watch_dir)
    else:
        run_storytelling(transport, args.watch_dir, args.script)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
