"""Regenerate tables_gen.h from the Python tables (single source of truth)."""

from __future__ import annotations

import os


def main() -> None:
    from ..tables import TABLE15_CODE, TABLE15_LEN

    path = os.path.join(os.path.dirname(__file__), "tables_gen.h")
    with open(path, "w") as f:
        f.write("// Generated from swiftmp3_tpu_torch.tables (ISO Table B.7, table 15).\n")
        f.write("// Regenerate with: python -m swiftmp3_tpu_torch.native.gen_tables\n")
        f.write("#pragma once\n#include <cstdint>\n\n")
        f.write("static const uint8_t TABLE15_LEN[256] = {\n")
        for i in range(0, 256, 16):
            f.write("    " + ", ".join(str(int(v)) for v in TABLE15_LEN[i : i + 16]) + ",\n")
        f.write("};\n\nstatic const uint16_t TABLE15_CODE[256] = {\n")
        for i in range(0, 256, 16):
            f.write("    " + ", ".join(str(int(v)) for v in TABLE15_CODE[i : i + 16]) + ",\n")
        f.write("};\n")
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
