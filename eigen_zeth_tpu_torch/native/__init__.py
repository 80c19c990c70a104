"""Native host engines of the port: the zethdb KV store (C++, g++ at first use)."""
