"""Stream name registry — the framework's analog of the reference's topic
constants (the reference's `utils/topics.py`).

There is no middleware here; these names key the dataset dictionaries,
checkpoint files, and per-step output tuples so producers and consumers
agree on identifiers the same way the ROS nodes agreed on topic strings.
"""


class Streams:
    # raw sensor streams
    IMU = "sensors/imu"
    IMU_MK_II = "sensors/imu_mk2"
    DVL = "sensors/dvl"
    DEPTH = "sensors/depth"
    GYRO = "sensors/gyro"
    SONAR = "sensors/sonar"
    SONAR_UNCOMPRESSED = "sensors/sonar_raw"
    SONAR_VERTICAL = "sensors/sonar_vertical"

    # derived streams
    GYRO_INTEGRATION = "estimators/gyro_integration"
    LOCALIZATION_ODOM = "estimators/odometry"
    SONAR_FEATURES = "features/points"
    SONAR_FEATURE_IMG = "features/image"

    # SLAM outputs
    SLAM_POSE = "slam/pose"
    SLAM_ODOM = "slam/odometry"
    SLAM_TRAJECTORY = "slam/trajectory"
    SLAM_CONSTRAINTS = "slam/constraints"
    SLAM_CLOUD = "slam/cloud"
    SLAM_STATE = "slam/state"

    # mapping outputs / services
    MAP_OCCUPANCY = "mapping/occupancy"
    MAP_INTENSITY = "mapping/intensity"
    GET_OCCUPANCY_MAP = "mapping/get_occupancy_map"
