"""Animated offline render: the scrolling display itself as an APNG.

Frame k is the live waterfall a viewer at ``fps`` sees at time k/fps —
driven through the real Stream → Waterfall path, so scroll-speed
semantics and emit latency are inherited and the final frame is
bit-identical to ``emspec stream``'s snapshot (the reference's product
is this motion: README.md:35-39)."""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from emspec import Settings, animate_frames, read_apng, write_apng
from emspec.io import synth

x = synth.chirp(100.0, 8000.0, 2.0) + synth.multitone([440.0, 880.0], 2.0,
                                                      amplitude=0.3)
s = Settings(mode="enhanced", multires=True, gain=5.0, colormap="inferno")
out = pathlib.Path(sys.argv[1] if len(sys.argv) > 1 else "anim.png")
# animate_frames is a generator and write_apng compresses one frame at a
# time — long animations never hold the raw frame stack
write_apng(out, animate_frames(x, s, fps=30.0, width=1024), fps=30.0)
frames, fps = read_apng(out)
print(f"wrote {out}: {frames.shape[0]} frames {frames.shape[1:]} @ {fps:g} fps")
print("open it in any browser — APNG plays like the live window")
