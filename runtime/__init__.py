"""Native runtime for the stereo engine.

C++ components (runtime/cpp, built with `make -C runtime/cpp`):
  png_codec.cc — libpng RGBA8 codec (replaces the reference's vendored
                 lodepng, ~8k LoC of stereo_matching/lodepng.{h,cpp}).

Python-side services built on them:
  loader — threaded prefetching stereo-pair loader feeding the device
           (replaces the reference's synchronous decode-then-upload at
           main.cpp:184-186,243-244).
"""
